"""Seconds per drive of the re-pack after the prune: the program's span
``prune.repack`` (the pruned host mask packed and uploaded again), the
mean over the window's drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "prune.repack")
