"""Optimizer steps completed in the window times the trials each advances,
over the whole window's seconds."""


def read(run):
    if run["kind"] != "train":
        return None
    w = run["window"]
    return w["calls"] * w["trials_per_call"] / w["seconds"]
