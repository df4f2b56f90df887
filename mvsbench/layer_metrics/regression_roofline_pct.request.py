"""The regression's (K2) bound over its span a request: CostRegNet's end
to the forward's end (hook events)."""

from mvsbench import roofline
from mvsbench.readers import mean_span_ms, roofline_pct


def read(record):
    s = record.get("shapes")
    if not s:
        return None
    return roofline_pct(roofline.regression_bound_s(s["B"], s["D"], s["h"], s["w"], s["logits"]),
                        mean_span_ms(record, "regression"))
