"""Seconds per drive of the prune's object-to-path index: the program's
span ``prune.index`` (``PathIndex``), the mean over the window's
drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "prune.index")
