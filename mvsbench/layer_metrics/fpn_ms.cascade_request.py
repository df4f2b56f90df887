"""CasMVSNet's feature pyramid, device ms a request: the port's
``casmvsnet.fpn`` span, first to last device operation launched inside it,
the mean over the window's requests."""

from mvsbench.spans import mean_device_ms


def read(record):
    return mean_device_ms(record, "casmvsnet.fpn")
