"""The per-pixel sweep's (K1, stages 2 and 3) bound over its device time: the
two stages' bounds (``roofline_cascade``: features and planes in, the volume
out) over the mean device ms of ``casmvsnet.sweep2`` plus ``casmvsnet.sweep3``."""

from mvsbench import roofline_cascade
from mvsbench.readers import roofline_pct
from mvsbench.spans import mean_device_ms


def read(record):
    s, stages = record.get("shapes"), record.get("stages")
    ms = [mean_device_ms(record, f"casmvsnet.sweep{k}") for k in (2, 3)]
    if not s or not stages or None in ms:
        return None
    bound = roofline_cascade.per_pixel_sweep_bound_s(s["B"], s["V"], stages[1:], s["feat"], s["vol"])
    return roofline_pct(bound, sum(ms))
