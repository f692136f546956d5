"""Rendering: shared constants and the fused renderer."""
