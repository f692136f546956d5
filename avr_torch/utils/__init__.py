"""Logging, profiling, figures and the report readers (TensorBoard events, config
sweeps), and microphone beam patterns."""
