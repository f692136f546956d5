"""Evaluation: direction-of-arrival estimators, the rotation sweep, the white-noise DoA
evaluation and the report aggregators (the last two need pandas and matplotlib)."""
