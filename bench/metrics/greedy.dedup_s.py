"""Seconds per drive of the greedy's path dedup: the program's span
``greedy.dedup`` (``normalize_path_budgets`` and ``prune_redundant``), the
mean over the window's drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "greedy.dedup")
