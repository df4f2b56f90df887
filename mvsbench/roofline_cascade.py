"""Operations and bytes of CasMVSNet's layers, from their shapes, on the
H100 peaks and the counting rules of ``roofline.py``.

The FPN counts its 13 convs (the bottom-up ConvBnReLU blocks, the 1x1 lateral
convs and the three output convs); its two nearest upsamplings and additions
are left out (under 0.1 % of its FLOPs). Each stage counts its CostRegNet
(the stage's input width), its variance sweep and its regression as MVSNet's
are counted. The per-pixel sweep and regression (stages 2 and 3) read their
planes too: a depth per plane and pixel, f32, read once. The hypotheses'
elementwise work (an upsampling and an affine map per plane and pixel) is
left out of the model FLOPs, as the public code's cost is counted.
"""

from __future__ import annotations

from . import roofline
from .roofline import BYTES, _down

# FPN convs: (in, out, kernel, stride, level of the output); level l is 1/2^l of (H, W)
FPN_CONVS = ((3, 8, 3, 1, 0), (8, 8, 3, 1, 0), (8, 16, 5, 2, 1), (16, 16, 3, 1, 1), (16, 16, 3, 1, 1),
             (16, 32, 5, 2, 2), (32, 32, 3, 1, 2), (32, 32, 3, 1, 2),
             (32, 32, 1, 1, 2), (16, 32, 1, 1, 1), (32, 16, 3, 1, 1), (8, 32, 1, 1, 0), (32, 8, 3, 1, 0))
CHANNELS = (32, 16, 8)  # the stages' feature widths


def fpn_macs(n_images: int, H: int, W: int) -> int:
    return sum(n_images * _down(H, lvl) * _down(W, lvl) * cout * cin * k * k for cin, cout, k, _, lvl in FPN_CONVS)


def costreg_macs(B: int, D: int, h: int, w: int, in_channels: int) -> int:
    """``roofline.costreg_macs`` with conv0's input width ``in_channels``."""
    voxels = B * D * h * w
    return roofline.costreg_macs(B, D, h, w) - voxels * (32 - in_channels) * 8 * 27


def stages(H: int, W: int, ndepths) -> list[dict]:
    """Each stage's planes, resolution and feature width: [{'D', 'h', 'w', 'C'}]."""
    return [{"D": n, "h": H // 4 * 2 ** s, "w": W // 4 * 2 ** s, "C": c}
            for s, (n, c) in enumerate(zip(ndepths, CHANNELS))]


def per_pixel_sweep_bytes(B: int, V: int, st: dict, feat: str, vol: str) -> int:
    """Features and the per-pixel planes in, the cost volume out."""
    D, h, w, C = st["D"], st["h"], st["w"], st["C"]
    return roofline.sweep_bytes(B, V, D, h, w, C, feat, vol) + B * D * h * w * 4


def per_pixel_regression_bytes(B: int, st: dict, logits: str) -> int:
    """The logits and the per-pixel planes in, depth and confidence (f32) out."""
    D, h, w = st["D"], st["h"], st["w"]
    return B * D * h * w * (BYTES[logits] + 4) + 2 * B * h * w * 4


def per_pixel_sweep_bound_s(B: int, V: int, sts: list[dict], feat: str, vol: str) -> float:
    """K1's bound summed over the per-pixel stages ``sts``; the elementwise
    work runs in f32."""
    return sum(roofline.bound_s(roofline.sweep_flops(B, V, s["D"], s["h"], s["w"], s["C"]),
                                per_pixel_sweep_bytes(B, V, s, feat, vol)) for s in sts)


def per_pixel_regression_bound_s(B: int, sts: list[dict], logits: str) -> float:
    """K2's bound summed over the per-pixel stages ``sts``."""
    return sum(roofline.bound_s(roofline.regression_flops(B, s["D"], s["h"], s["w"]),
                                per_pixel_regression_bytes(B, s, logits)) for s in sts)


def forward_flops(B: int, V: int, H: int, W: int, ndepths) -> int:
    """Model FLOPs of one CasMVSNet forward on [B, V, H, W, 3] images."""
    total = 2 * fpn_macs(B * V, H, W)
    for s in stages(H, W, ndepths):
        D, h, w, C = s["D"], s["h"], s["w"], s["C"]
        total += (2 * costreg_macs(B, D, h, w, C) + roofline.sweep_flops(B, V, D, h, w, C)
                  + roofline.regression_flops(B, D, h, w))
    return total
