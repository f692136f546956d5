"""Seconds from the process's start to the end of warm-up: imports, kernel
builds or loads, weights, inputs, and the first calls."""


def read(run):
    return run["setup_s"]
