"""Model FLOPs of the train steps done in the window (3 x the forward's, from
the shapes) over the window, as a share of the H100's bf16 peak."""

from mvsbench.readers import mfu_pct


def read(record):
    return mfu_pct(record.get("flops_per_step"), record.get("steps"), record.get("window_s"))
