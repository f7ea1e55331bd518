"""Seconds per drive of the prune's first walk: the program's span
``prune.precheck`` (every path walked under the policy, read back and
checked against its budget), the mean over the window's drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "prune.precheck")
