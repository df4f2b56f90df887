"""CostRegNet backward ms a train step: hook events, the logits' gradient to
its input's gradient (the cost volume's)."""

from mvsbench.readers import mean_span_ms


def read(record):
    return mean_span_ms(record, "costreg_bwd")
