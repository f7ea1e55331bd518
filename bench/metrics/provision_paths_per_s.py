"""Paths provisioned per second: every path of every drive in the window
over the window's seconds, from the first drive's start to the last
drive's end (the host's clock)."""


def read(run):
    return sum(x["paths"] for x in run.drives) / run.window_s
