"""Model FLOPs of the depth maps delivered in the window (the forward's, from
the shapes) over the window, as a share of the H100's bf16 peak."""

from mvsbench.readers import mfu_pct


def read(record):
    return mfu_pct(record.get("flops_per_depthmap"), record.get("depthmaps"), record.get("window_s"))
