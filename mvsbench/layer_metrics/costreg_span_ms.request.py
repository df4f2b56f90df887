"""CostRegNet's device ms a request: the port's ``mvsnet.costreg`` span,
first to last device operation launched inside it (the trace joined with
the spans), the mean over the window's requests."""

from mvsbench.spans import mean_device_ms


def read(record):
    return mean_device_ms(record, "mvsnet.costreg")
