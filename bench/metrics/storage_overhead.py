"""Replicated bytes over original bytes of the schemes the window's
drives produced, recomputed by the harness from each mask and f
(float64), the mean over the drives."""


def read(run):
    return sum(x["overhead"] for x in run.drives) / len(run.drives)
