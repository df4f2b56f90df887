"""Operations and bytes of R-MVSNet's layers, from their shapes, on the H100
peaks and the counting rules of ``roofline.py``.

Model FLOPs are 2 x the multiply-accumulates of every convolution: FeatureNet
(``roofline.feature_macs``) and, at every plane, the 32 -> 16 conv, each GRU
cell's gates (2 hidden outputs) and candidate (hidden outputs) on their
input and state channels, and the 2 -> 1 logit conv, all 3x3; plus the
variance sweep's elementwise operations (``roofline.sweep_flops``) and the
winner-take-all pass, counted as MVSNet's regression is
(``roofline.regression_flops``). The cells' elementwise gate arithmetic
(sigmoid, tanh and the update, about 12 operations a hidden channel and
pixel, under 0.1 % of the convs') is left out.

K1's bound counts the whole request's sweep: the features read once and the
D cost maps written once, though K1 runs a chunk of planes at a time.
"""

from __future__ import annotations

from . import roofline

COST_CHANNELS = 16  # the 32 -> 16 conv ahead of the first cell
GRU_CHANNELS = (16, 4, 2)
TAPS = 9  # 3x3 kernels


def recurrence_macs_per_pixel(C: int = 32) -> int:
    """One plane's conv MACs a pixel: the 32 -> 16 conv, each cell's gates and
    candidate on [x, h], and the logit conv."""
    macs = C * COST_CHANNELS * TAPS
    width = COST_CHANNELS
    for hidden in GRU_CHANNELS:
        macs += (width + hidden) * 3 * hidden * TAPS  # gates (2 hidden) and candidate (hidden)
        width = hidden
    return macs + width * 1 * TAPS


def recurrence_flops(B: int, D: int, h: int, w: int, C: int = 32) -> int:
    return 2 * B * D * h * w * recurrence_macs_per_pixel(C)


def sweep_bound_s(B: int, V: int, D: int, h: int, w: int, C: int, feat: str, vol: str) -> float:
    """K1 over every plane of the request: ``roofline.sweep_bound_s``."""
    return roofline.sweep_bound_s(B, V, D, h, w, C, feat, vol)


def forward_flops(B: int, V: int, D: int, H: int, W: int, C: int = 32) -> int:
    """Model FLOPs of one R-MVSNet forward on [B, V, H, W, 3] images."""
    h, w = H // 4, W // 4
    return (2 * roofline.feature_macs(B * V, H, W) + roofline.sweep_flops(B, V, D, h, w, C)
            + recurrence_flops(B, D, h, w, C) + roofline.regression_flops(B, D, h, w))
