"""R-MVSNet's recurrent regulariser, device ms a request: the port's
``rmvsnet.recurrence`` span (every plane: K1's chunks, the 32 -> 16 conv, the
three GRU cells and the logit conv), first to last device operation launched
inside it, the mean over the window's requests."""

from mvsbench.spans import mean_device_ms


def read(record):
    return mean_device_ms(record, "rmvsnet.recurrence")
