"""R-MVSNet's FeatureNet, device ms a request: the port's ``rmvsnet.features``
span, first to last device operation launched inside it, the mean over the
window's requests."""

from mvsbench.spans import mean_device_ms


def read(record):
    return mean_device_ms(record, "rmvsnet.features")
