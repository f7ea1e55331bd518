"""``prune_walk``'s share of its roofline, %: the least time its bytes
need at the chip's memory rate (``bench/roofline/prune_walk.py``, the
sweep the reference followed in each sampled drive, their mean once per
drive) over the device time of its launches in the traced window.
Nothing without a trace or a launch."""
from bench.roofline import hbm_bytes_per_s, prune_walk


def read(run):
    if run.trace is None or not run.references:
        return None
    dev_s = sum(s for name, s in run.trace["ops"] if prune_walk.KERNEL in name)
    W = (run.inputs.n_servers + 31) // 32
    each = [prune_walk.drive_bytes(r, r["objects"], W) for r in run.references]
    if not dev_s or any(b is None for b in each):
        return None
    return 100.0 * sum(each) / len(each) * len(run.drives) / hbm_bytes_per_s() / dev_s
