"""Seconds per drive of the greedy's gate and UPDATE stages: the
program's ``GreedyStats.stage_s`` "gate" + "update" (each booked after the
device caught up), the mean over the window's drives."""


def read(run):
    d = run.drives
    return sum(x["stage_s"].get("gate", 0.0) + x["stage_s"].get("update", 0.0) for x in d) / len(d)
