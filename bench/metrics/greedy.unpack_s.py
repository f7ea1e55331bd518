"""Seconds per drive of the greedy's host mask: the program's spans
``greedy.unpack`` (the readback and unpack of the packed words, the
replica count), the mean over the window's drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "greedy.unpack")
