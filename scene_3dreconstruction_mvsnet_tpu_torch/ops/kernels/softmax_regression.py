"""Fused softmax regression and photometric confidence (K2, Triton).

Replaces the TPU kernel ``scene_3dreconstruction_mvsnet_tpu/ops/pallas/
softmax_regression.py::fused_softmax_regression``. Per pixel: the max over
the D planes, exp once, the sum, the expectation of the depth values and of
the plane index, depth = E[d]; confidence = the exp mass in the window
[idx-1, idx+2] over the sum, with idx = trunc(clip(E[index], 0, D-1)).

Bound on the H100: reading the [D, H, W] f32 logits once (192 x 62,208 x 4 B
~ 48 MB at the headline shape); there is no reuse across pixels and no
matrix work. Design: one program per block of pixels holds the whole padded
D axis (a power of two) in registers, so the logits are read once and the
probability volume is never written. The TPU kernel's exp scratch and
unrolled D loop answered a TPU register limit and are not copied.

A CPU tensor takes the plain version (``ops/regression.py``); a CUDA tensor
launches the kernel or raises. ``triton`` is imported at the first launch.
"""

from __future__ import annotations

import functools
import os

import torch

from ..regression import regress_depth_and_confidence
from . import BUILD_DIR, check_cuda_tensor

LAUNCHES = 0  # kernel launches since the last reset; only the launch site adds to it

BLOCK_P = 32  # pixels per program
NUM_WARPS = 8


@functools.lru_cache(maxsize=None)
def _kernel():
    # Triton's compile cache goes beside the CUDA builds, inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR.parent / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def softmax_regression_kernel(
        cost_ptr, dv_ptr, depth_ptr, conf_ptr, D, HW,
        D_PAD: tl.constexpr, BLOCK: tl.constexpr,
    ):
        b = tl.program_id(1)
        offs_p = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        offs_d = tl.arange(0, D_PAD)
        mask_p = offs_p < HW
        mask_d = offs_d < D
        mask = mask_d[:, None] & mask_p[None, :]
        base = b.to(tl.int64) * D * HW
        x = tl.load(
            cost_ptr + base + offs_d[:, None] * HW + offs_p[None, :],
            mask=mask, other=-float("inf"),
        )
        m = tl.max(x, axis=0)
        m = tl.where(mask_p, m, 0.0)  # a padded pixel column is all -inf
        e = tl.where(mask, tl.exp(x - m[None, :]), 0.0)
        s = tl.sum(e, axis=0)
        dv = tl.load(dv_ptr + b * D + offs_d, mask=mask_d, other=0.0)
        depth = tl.sum(e * dv[:, None], axis=0) / s
        e_idx = tl.sum(e * offs_d.to(tl.float32)[:, None], axis=0) / s
        idx = tl.minimum(tl.maximum(e_idx, 0.0), D - 1.0).to(tl.int32)  # truncates
        d = offs_d[:, None]
        window = (d >= idx[None, :] - 1) & (d <= idx[None, :] + 2)
        conf = tl.sum(tl.where(window, e, 0.0), axis=0) / s
        out = b.to(tl.int64) * HW + offs_p
        tl.store(depth_ptr + out, depth, mask=mask_p)
        tl.store(conf_ptr + out, conf, mask=mask_p)

    return triton, softmax_regression_kernel


def softmax_regression_cuda(
    cost_reg: torch.Tensor, depth_values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2: cost_reg [B, D, H, W] f32 logits, depth_values [B, D] f32
    -> (depth [B, H, W], confidence [B, H, W]) f32."""
    global LAUNCHES
    device = cost_reg.device
    if device.type != "cuda":
        raise ValueError(f"softmax_regression_cuda takes CUDA tensors, got {device}")
    check_cuda_tensor(cost_reg, "cost_reg", (torch.float32,), 4, device, align=4)
    check_cuda_tensor(depth_values, "depth_values", (torch.float32,), 2, device, align=4)
    B, D, H, W = cost_reg.shape
    if tuple(depth_values.shape) != (B, D):
        raise ValueError(f"depth_values must be [{B}, {D}], got {tuple(depth_values.shape)}")
    triton, kernel = _kernel()
    depth = torch.empty((B, H, W), dtype=torch.float32, device=device)
    conf = torch.empty((B, H, W), dtype=torch.float32, device=device)
    grid = (triton.cdiv(H * W, BLOCK_P), B)
    with torch.cuda.device(device):
        kernel[grid](
            cost_reg, depth_values, depth, conf, D, H * W,
            D_PAD=triton.next_power_of_2(D), BLOCK=BLOCK_P, num_warps=NUM_WARPS,
        )
    LAUNCHES += 1
    return depth, conf


def softmax_regression(
    cost_reg: torch.Tensor, depth_values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth and photometric confidence from the regularised cost
    [B, D, H, W] (f32 logits) and depth values [B, D]: the plain path for CPU
    tensors, K2 for CUDA tensors."""
    if cost_reg.device.type == "cpu":
        return regress_depth_and_confidence(cost_reg, depth_values)
    return softmax_regression_cuda(cost_reg, depth_values)
