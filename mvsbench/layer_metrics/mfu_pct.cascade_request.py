"""Model FLOPs of the depth maps delivered in the window (CasMVSNet's
forward, ``roofline_cascade.forward_flops``) over the window, as a share of
the H100's bf16 peak."""

from mvsbench.readers import mfu_pct


def read(record):
    return mfu_pct(record.get("flops_per_depthmap"), record.get("depthmaps"), record.get("window_s"))
