"""Readbacks per drive, each a wait for the device: the change of the
program's ``TRANSFER.d2h_calls`` over each drive's top-level spans, the
mean over the window's drives."""
from bench import spans


def read(run):
    return spans.count(run, "d2h_calls")
