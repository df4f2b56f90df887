"""The sweep backward's (K3-terms + K3) bound over its span a train step:
the cost volume's gradient to the features' gradient (hook events)."""

from mvsbench import roofline
from mvsbench.readers import mean_span_ms, roofline_pct


def read(record):
    s = record.get("shapes")
    if not s:
        return None
    bound = roofline.sweep_backward_bound_s(s["B"], s["V"], s["D"], s["h"], s["w"], s["C"], s["feat"], s["vol"])
    return roofline_pct(bound, mean_span_ms(record, "sweep_bwd"))
