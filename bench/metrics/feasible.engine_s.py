"""Seconds per drive of the feasibility check's engine build: the
program's span ``feasible.engine`` (the whole host mask packed and
uploaded), the mean over the window's drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "feasible.engine")
