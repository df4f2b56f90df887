"""The serving entry's host ms a request: the request's wall (host clock,
host arrays in to depth and confidence on the host) minus the forward's
device span (the model's pre-hook to its post-hook, CUDA events)."""

import statistics


def read(record):
    walls, spans = record.get("walls_s"), record.get("spans_ms", {}).get("forward")
    if not walls or not spans or len(walls) != len(spans):
        return None
    return statistics.fmean(1e3 * w - s for w, s in zip(walls, spans))
