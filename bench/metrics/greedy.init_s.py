"""Seconds per drive of the greedy's set-up: the program's span
``greedy.init`` (the scheme from the sharding, the packed words, the f,
load and capacity uploads, the gate and the fused drive), the mean over
the window's drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "greedy.init")
