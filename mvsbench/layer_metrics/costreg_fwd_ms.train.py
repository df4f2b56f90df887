"""CostRegNet forward ms a train step: hook events, its pre-hook to its post-hook."""

from mvsbench.readers import mean_span_ms


def read(record):
    return mean_span_ms(record, "costreg_fwd")
