"""Seconds per drive of the budget-class plans: the program's spans
``greedy.plan`` (the class split, the h walk and its readback, the C(h, t)
tables), revalidation rounds included, the mean over the window's
drives."""
from bench import spans


def read(run):
    return spans.seconds(run, "greedy.plan")
