"""Seconds per drive of ``replicate_workload`` outside its child spans:
the self time of the program's span ``greedy.replicate_workload`` (its
span less the seconds its ``greedy.*`` and ``prune`` children cover), the
mean over the window's drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "greedy.replicate_workload", "self_s")
