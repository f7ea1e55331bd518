"""Seconds from the process's start to the first timed drive: the inputs
made, the kernel library loaded (built on a checkout's first run) and
one warm drive."""


def read(run):
    return run.setup_s
