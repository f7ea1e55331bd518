"""Kernel launches per drive: the difference across each drive of the
program's launch counters (``path_latency``, ``routed_walk`` and its
scored entry, ``provision_update`` and ``prune_walk`` and its scored
entry), the mean over the window's drives."""


def read(run):
    return sum(x["launches"] for x in run.drives) / len(run.drives)
