"""The device's idle share of the traced window, %: the seconds in which
no kernel, copy or set ran on the card (the profiler's timeline) over the
window, from the first drive's start to the last drive's end."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
