"""Logging, profiling and validation figures."""
