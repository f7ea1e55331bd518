"""Megabytes (10^6 B) the engine uploads per drive: the difference of the
program's ``engine.streaming.TRANSFER.h2d_bytes`` across each drive, the
mean over the window's drives."""


def read(run):
    return sum(x["h2d_bytes"] for x in run.drives) / len(run.drives) / 1e6
