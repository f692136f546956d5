"""Benchmark of avr_torch, the PyTorch and CUDA port: see run.py."""
