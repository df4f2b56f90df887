"""Bilinear sampling with zeros padding, and the plane-sweep homography warp.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/ops/sampling.py``, plain
PyTorch. The sampling composition is the reference's: it builds its
normalised grid with the align_corners=True rule ``x / ((W-1)/2) - 1`` and
samples with ``F.grid_sample``'s default align_corners=False, so the
effective pixel coordinate is ``x * W/(W-1) - 0.5``. Feeding that normalised
grid to ``F.grid_sample(align_corners=False)`` reproduces it exactly. Taps
outside the image contribute 0 and the weights are not renormalised.

Public layouts are channels-last, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry.transforms import plane_sweep_coords


def bilinear_sample_2d(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` [B, H, W, C] at float pixel coords ``x``/``y`` [B, N]
    with bilinear interpolation and zeros padding -> [B, N, C] in the image
    dtype (weights and interpolation in f32)."""
    B, H, W, C = img.shape
    x = x.float()
    y = y.float()
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = (x - x0f)[..., None]
    wy = (y - y0f)[..., None]
    # clamp the footprint origin into a 2-px zero border: far-out coordinates
    # then read only zeros, which is exactly zeros padding
    x0 = x0f.clamp(-2.0, float(W)).long() + 2
    y0 = y0f.clamp(-2.0, float(H)).long() + 2
    padded = F.pad(img.float(), (0, 0, 2, 2, 2, 2))  # [B, H+4, W+4, C]
    Wp = W + 4
    flat = padded.reshape(B, -1, C)

    def tap(dy, dx):
        idx = ((y0 + dy) * Wp + (x0 + dx))[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx)

    top = tap(0, 0) * (1.0 - wx) + tap(0, 1) * wx
    bot = tap(1, 0) * (1.0 - wx) + tap(1, 1) * wx
    return (top * (1.0 - wy) + bot * wy).to(img.dtype)


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear ``F.grid_sample`` (zeros padding, align_corners=False) on
    channels-last tensors: img [B, H, W, C], grid [B, Hg, Wg, 2] normalised
    (x, y) -> [B, Hg, Wg, C]."""
    out = F.grid_sample(
        img.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros", align_corners=False
    )
    return out.permute(0, 2, 3, 1)


def warp_src_feature_ncdhw(
    src_fea: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth_values: torch.Tensor,
) -> torch.Tensor:
    """``warp_src_feature`` in NCDHW and f32: src_fea [B, H, W, C] ->
    [B, C, D, H, W], the layout ``F.grid_sample`` emits (the sweep
    accumulates in it and permutes once at the end). Features of any float
    dtype are sampled in f32, so the grid keeps full f32 precision."""
    B, H, W, C = src_fea.shape
    D = depth_values.shape[1]
    px, py = plane_sweep_coords(src_proj, ref_proj, depth_values, H, W)  # [B, D, HW]
    # the reference's normalisation (align_corners=True rule), undone by the
    # sampler's align_corners=False rule
    gx = px / ((W - 1) / 2.0) - 1.0
    gy = py / ((H - 1) / 2.0) - 1.0
    grid = torch.stack([gx, gy], dim=-1).reshape(B, D * H, W, 2)
    out = F.grid_sample(
        src_fea.permute(0, 3, 1, 2).float(), grid, mode="bilinear",
        padding_mode="zeros", align_corners=False,
    )  # [B, C, D*H, W]
    return out.reshape(B, C, D, H, W)


def warp_src_feature(
    src_fea: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth_values: torch.Tensor,
) -> torch.Tensor:
    """Homography warp of a source feature map over a sweep of
    fronto-parallel depth planes.

    src_fea [B, H, W, C]; src_proj, ref_proj [B, 4, 4] K@E; depth_values
    [B, D] -> [B, D, H, W, C], zeros where a plane projects outside the
    source image."""
    out = warp_src_feature_ncdhw(src_fea, src_proj, ref_proj, depth_values)
    return out.permute(0, 2, 3, 4, 1).to(src_fea.dtype)
