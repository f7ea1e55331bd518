"""Seconds per drive of the prune's candidate list: the program's span
``prune.candidates`` (the host mask copied, its replicas found and sorted
by size), the mean over the window's drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "prune.candidates")
