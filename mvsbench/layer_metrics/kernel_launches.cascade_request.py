"""The hand-written kernels' launches a request: the port's launch counts
over the window (reset at its start) over the window's requests; 3 K1 and 3
K2 launches, 2 of each per-pixel."""

from mvsbench.spans import launches_per


def read(record):
    return launches_per(record, "requests")
