"""The per-pixel regression's (K2, stages 2 and 3) bound over its device
time: the two stages' bounds (``roofline_cascade``: logits and planes in,
depth and confidence out) over the mean device ms of ``casmvsnet.regress2``
plus ``casmvsnet.regress3``."""

from mvsbench import roofline_cascade
from mvsbench.readers import roofline_pct
from mvsbench.spans import mean_device_ms


def read(record):
    s, stages = record.get("shapes"), record.get("stages")
    ms = [mean_device_ms(record, f"casmvsnet.regress{k}") for k in (2, 3)]
    if not s or not stages or None in ms:
        return None
    return roofline_pct(roofline_cascade.per_pixel_regression_bound_s(s["B"], stages[1:], s["logits"]), sum(ms))
