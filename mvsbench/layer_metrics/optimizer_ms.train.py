"""Adam's ms a train step: the optimizer's step pre-hook to its post-hook."""

from mvsbench.readers import mean_span_ms


def read(record):
    return mean_span_ms(record, "optimizer")
