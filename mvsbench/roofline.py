"""Operations and bytes of MVSNet's layers, from their shapes, and the
NVIDIA H100's published peaks (SXM, dense, at its 700 W limit).

A layer's bound is the least time the card could take for it: the larger of
its operations at the peak of the type they run in and its bytes at the HBM
bandwidth, counting the layer's mathematical inputs read once and its outputs
written once, whatever an implementation stores in between (K1-emit's warps,
K3-terms' ``t``). Counts are taken over every bilinear tap, also those that
fall outside the source image and read zeros.

Model FLOPs are 2 x the multiply-accumulates of every convolution (a
transposed convolution counted on its input voxels, as
``torch.utils.flop_counter`` counts it) plus the sweep's and the
regression's elementwise operations; a train step counts 3 x the forward.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bf16": 2, "f32": 4}

# FeatureNet: (in channels, out channels, kernel, stride), padding kernel // 2
FEATURE_LAYERS = ((3, 8, 3, 1), (8, 8, 3, 1), (8, 16, 5, 2), (16, 16, 3, 1), (16, 16, 3, 1), (16, 32, 5, 2),
                  (32, 32, 3, 1), (32, 32, 3, 1))
# CostRegNet: (in, out, level of the input, level of the output); level l is 1/2^l of (D, h, w);
# a transposed conv goes up one level and is counted on its input
COSTREG_CONVS = ((32, 8, 0, 0), (8, 16, 0, 1), (16, 16, 1, 1), (16, 32, 1, 2), (32, 32, 2, 2), (32, 64, 2, 3),
                 (64, 64, 3, 3), (8, 1, 0, 0))
COSTREG_DECONVS = ((64, 32, 3), (32, 16, 2), (16, 8, 1))
COORD_FLOPS = 8  # a source pixel's coordinates at one plane: 6 multiply-adds' worth and the divide
TAP_FLOPS = 8  # a bilinear sample of one channel: 4 taps, a multiply and an add each
REGRESSION_FLOPS = 12  # per (plane, pixel): softmax 5, depth 2, plane index 2, window 3


def _down(n: int, level: int) -> int:
    for _ in range(level):
        n = (n + 1) // 2
    return n


def feature_macs(n_images: int, H: int, W: int) -> int:
    macs = 0
    for cin, cout, k, stride in FEATURE_LAYERS:
        H, W = (H + 2 * (k // 2) - k) // stride + 1, (W + 2 * (k // 2) - k) // stride + 1
        macs += n_images * H * W * cout * cin * k * k
    return macs


def costreg_macs(B: int, D: int, h: int, w: int) -> int:
    def voxels(level):
        return B * _down(D, level) * _down(h, level) * _down(w, level)

    return (sum(voxels(lo) * cin * cout * 27 for cin, cout, _, lo in COSTREG_CONVS)
            + sum(voxels(li) * cin * cout * 27 for cin, cout, li in COSTREG_DECONVS))


def sweep_flops(B: int, V: int, D: int, h: int, w: int, C: int = 32) -> int:
    """The variance sweep: per source view, plane and pixel the coordinates,
    per channel a bilinear sample and the two moments (3); per plane, pixel
    and channel the reference view's moments and the variance (5)."""
    return B * D * h * w * ((V - 1) * (COORD_FLOPS + C * (TAP_FLOPS + 3)) + 5 * C)


def sweep_bytes(B: int, V: int, D: int, h: int, w: int, C: int, feat: str, vol: str) -> int:
    """Features in, the cost volume out (cameras and planes are negligible)."""
    return B * V * h * w * C * BYTES[feat] + B * D * h * w * C * BYTES[vol]


def sweep_backward_flops(B: int, V: int, D: int, h: int, w: int, C: int = 32) -> int:
    """The variance's gradient to the features through the warp: per source
    view, plane and pixel the coordinates, per channel the warped value again
    (8), its term 2/V (x - mean) g (3) and its scatter to 4 taps (8); per
    plane, pixel and channel the mean (V + 1) and the reference view's term
    and its sum over planes (4)."""
    return B * D * h * w * ((V - 1) * (COORD_FLOPS + C * 19) + C * (V + 5))


def sweep_backward_bytes(B: int, V: int, D: int, h: int, w: int, C: int, feat: str, vol: str) -> int:
    """The volume's gradient and the features in, the features' f32 gradient out."""
    return B * D * h * w * C * BYTES[vol] + B * V * h * w * C * (BYTES[feat] + 4)


def regression_flops(B: int, D: int, h: int, w: int) -> int:
    return B * D * h * w * REGRESSION_FLOPS


def regression_bytes(B: int, D: int, h: int, w: int, logits: str) -> int:
    """The logits and the planes in, depth and confidence (f32) out."""
    return B * D * h * w * BYTES[logits] + B * D * 4 + 2 * B * h * w * 4


def bound_s(flops: float, nbytes: float, peak: str = "f32") -> float:
    return max(flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S)


def sweep_bound_s(B, V, D, h, w, C, feat, vol) -> float:
    """The sweep's elementwise work runs in f32 whatever the storage type."""
    return bound_s(sweep_flops(B, V, D, h, w, C), sweep_bytes(B, V, D, h, w, C, feat, vol))


def sweep_backward_bound_s(B, V, D, h, w, C, feat, vol) -> float:
    return bound_s(sweep_backward_flops(B, V, D, h, w, C), sweep_backward_bytes(B, V, D, h, w, C, feat, vol))


def regression_bound_s(B, D, h, w, logits) -> float:
    return bound_s(regression_flops(B, D, h, w), regression_bytes(B, D, h, w, logits))


def forward_flops(B: int, V: int, D: int, H: int, W: int, C: int = 32) -> int:
    """Model FLOPs of one MVSNet forward on [B, V, H, W, 3] images."""
    h, w = H // 4, W // 4
    return (2 * (feature_macs(B * V, H, W) + costreg_macs(B, D, h, w)) + sweep_flops(B, V, D, h, w, C)
            + regression_flops(B, D, h, w))


def train_step_flops(B: int, V: int, D: int, H: int, W: int, C: int = 32) -> int:
    return 3 * forward_flops(B, V, D, H, W, C)
