"""Evaluation: direction-of-arrival estimators and the rotation sweep."""
