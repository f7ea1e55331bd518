"""Seconds per drive of the ``nearest_copy`` prune (the program's
``GreedyStats.stage_s["prune"]``, its sweep launch included), the mean
over the window's drives."""


def read(run):
    d = run.drives
    return sum(x["stage_s"].get("prune", 0.0) for x in d) / len(d)
