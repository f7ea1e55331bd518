"""Seconds per drive of the prune's sweep call: the program's span
``prune.sweep`` (the uploads, the ``prune_walk`` launch and its readback;
the interval ``GreedyStats.stage_s["prune_walk"]`` books), the mean over
the window's drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "prune.sweep")
