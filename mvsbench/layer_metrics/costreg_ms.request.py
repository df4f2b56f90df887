"""CostRegNet ms a request: its pre-hook to its post-hook (CUDA events)."""

from mvsbench.readers import mean_span_ms


def read(record):
    return mean_span_ms(record, "costreg_fwd")
