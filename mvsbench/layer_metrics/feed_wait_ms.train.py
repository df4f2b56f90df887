"""The train step's wait for its batch: the port's ``feed.wait`` span
(``prefetch_to_device`` waiting for and handing over the next batch), its
host ms over the window, over the steps."""

from mvsbench.spans import host_ms_per


def read(record):
    return host_ms_per(record, "feed.wait", "steps")
