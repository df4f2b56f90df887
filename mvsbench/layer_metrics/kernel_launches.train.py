"""The hand-written kernels' launches a train step: the port's launch counts
over the window (reset at its start) over the window's steps."""

from mvsbench.spans import launches_per


def read(record):
    return launches_per(record, "steps")
