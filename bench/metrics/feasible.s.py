"""Seconds per drive of ``is_latency_feasible``: the harness's span
around the call, the mean over the window's drives."""


def read(run):
    return sum(x["feasible_s"] for x in run.drives) / len(run.drives)
