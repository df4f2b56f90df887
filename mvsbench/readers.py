"""What the per-layer metrics' readers share (``layer_metrics/*.py``): each
reader takes the run's record and returns its metric, or None where the
record holds nothing for it."""

from __future__ import annotations

import statistics

from . import roofline


def mean_span_ms(record: dict, span: str) -> float | None:
    values = record.get("spans_ms", {}).get(span)
    return statistics.fmean(values) if values else None


def roofline_pct(bound_s: float, span_ms: float | None) -> float | None:
    """A layer's bound over its measured span, in %."""
    return None if not span_ms else 100.0 * bound_s / (span_ms / 1e3)


def idle_pct(record: dict) -> float | None:
    trace = record.get("trace")
    if not trace or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu_pct(flops_per_item: float | None, items: int | None, window_s: float | None) -> float | None:
    """Model FLOPs done over the window, as a share of the card's bf16 peak."""
    if not flops_per_item or not items or not window_s:
        return None
    return 100.0 * flops_per_item * items / window_s / roofline.PEAK_FLOPS["bf16"]
