"""The sweep backward's (K3-terms + K3) device ms a train step: the port's
``sweep.backward`` span on the autograd engine's thread, first to last
device operation launched inside it, the mean over the window's steps."""

from mvsbench.spans import mean_device_ms


def read(record):
    return mean_device_ms(record, "sweep.backward")
