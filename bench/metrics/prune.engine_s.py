"""Seconds per drive of the prune's engine build: the program's span
``prune.engine`` (the whole host mask packed and uploaded), the mean over
the window's drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "prune.engine")
