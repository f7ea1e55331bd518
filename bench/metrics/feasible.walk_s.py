"""Seconds per drive of the feasibility check's walk: the program's
span ``feasible.walk`` (the path uploads, the launch and its readback),
the mean over the window's drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "feasible.walk")
