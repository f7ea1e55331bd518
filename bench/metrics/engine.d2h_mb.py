"""Megabytes (10^6 B) the engine reads back per drive: the change of the
program's ``TRANSFER.d2h_bytes`` over each drive's top-level spans, the
mean over the window's drives."""
from bench import spans


def read(run):
    return spans.count(run, "d2h_bytes", scale=1e-6)
