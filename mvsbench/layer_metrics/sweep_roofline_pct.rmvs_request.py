"""The sweep's (K1's chunks) bound over its device time: the bound of the
request's whole sweep (``roofline_rmvs.sweep_bound_s``: the features read
once, every plane's cost map written once) over the device ms of the port's
``rmvsnet.sweep`` spans a request (each chunk's first to last device
operation, the wrapper's ``homography_terms`` among them, summed over the
traced window and divided by its ``rmvsnet.recurrence`` spans, one a
request)."""

from mvsbench import roofline_rmvs
from mvsbench.readers import roofline_pct


def read(record):
    spans = (record.get("trace") or {}).get("span_device_ms", {})
    s, chunks, requests = record.get("shapes"), spans.get("rmvsnet.sweep"), spans.get("rmvsnet.recurrence")
    if not s or not chunks or not requests:
        return None
    bound = roofline_rmvs.sweep_bound_s(s["B"], s["V"], s["D"], s["h"], s["w"], s["C"], s["feat"], s["vol"])
    return roofline_pct(bound, sum(chunks) / len(requests))
