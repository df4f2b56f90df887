"""The device's idle share of the traced window: 1 - the union of its
operations' intervals (torch.profiler) over the window."""

from mvsbench.readers import idle_pct


def read(record):
    return idle_pct(record)
