"""Paired plane-sweep cost volume: the training path's sweep, as one
``torch.autograd.Function``.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/ops/paired_sweep.py::
make_paired_cost_volume``:

  forward:  the sweep-variance kernel with ``emit_warps`` (K1, one launch
            per sample) gives the variance volume and each source view's
            warped volume; the warps, the features and the geometry are
            saved for the backward.
  backward: the variance's VJP with respect to view v's warped values is
            (2/V) * g * (w_v - mean), an elementwise volume, and the
            reference view's gradient is the direct reduction
            sum_d (2/V) * g * (ref - mean); ``mean`` is built from the
            emitted warps, rounded to the output dtype, as the JAX package
            builds it. On the card one launch of the terms kernel
            (K3-terms) computes both for the batch, then one launch of the
            warp-backward kernel (K3) takes every source view's transpose;
            the two write straight into the feature gradient, in the
            features' dtype, and no plain elementwise op runs. Neither
            kernel uses atomics, so the gradient is the same bit for bit from
            run to run.

Gradients flow to the feature values only: the sweep coordinates are
constants, so the projections and depth values get none. The TPU version's
plan validity output is not ported: it exists because the TPU kernels have
static window envelopes, and a GPU thread reads and writes any address.

On the CPU both directions take the kernels' plain versions (the wrappers
dispatch on the device), one sample at a time, so the backward formula is
tested there.
"""

from __future__ import annotations

import torch

from .kernels.paired_grad import paired_grad
from .kernels.sweep_variance import sweep_variance
from .kernels.warp_grad import warp_grad


class PairedCostVolume(torch.autograd.Function):
    """(features [B, V, H, W, C], proj_matrices [B, V, 4, 4] f32,
    depth_values [B, D] f32, out_dtype, depth_chunk) -> variance volume
    [B, D, H, W, C] in ``out_dtype``. ``depth_chunk`` bounds the plain
    path's memory on the CPU and is ignored by the kernel."""

    @staticmethod
    def forward(ctx, features, proj_matrices, depth_values, out_dtype, depth_chunk):
        volume, warps = sweep_variance(
            features, proj_matrices, depth_values, depth_chunk=depth_chunk, out_dtype=out_dtype,
            emit_warps=True,
        )
        ctx.save_for_backward(warps, features, proj_matrices, depth_values)
        return volume

    @staticmethod
    def backward(ctx, g_vol):
        warps, features, proj, depth = ctx.saved_tensors
        B, V = features.shape[:2]
        dfeat = torch.empty(features.shape, dtype=features.dtype, device=features.device)
        # the card takes the batch in one launch of each kernel; the plain
        # versions take one sample at a time, which bounds their f32 temporaries
        parts = [slice(None)] if features.is_cuda else [slice(b, b + 1) for b in range(B)]
        for s in parts:
            t, _ = paired_grad(g_vol[s], warps[s], features[s], dref_out=dfeat[s, 0])
            # every (sample, source view) pair's transpose, into dfeat's source views
            warp_grad(
                t.flatten(0, 1), proj[s, 1:].flatten(0, 1), proj[s, :1].expand(-1, V - 1, -1, -1).flatten(0, 1),
                depth[s, None].expand(-1, V - 1, -1).flatten(0, 1), out=dfeat[s, 1:],
            )
        return dfeat, None, None, None, None


def paired_cost_volume(
    features: torch.Tensor,
    proj_matrices: torch.Tensor,
    depth_values: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    depth_chunk: int | None = None,
) -> torch.Tensor:
    """Differentiable variance cost volume for training: features
    [B, V, H, W, C] (view 0 = reference), proj_matrices [B, V, 4, 4] f32,
    depth_values [B, D] f32 -> [B, D, H, W, C] in ``out_dtype`` (default: the
    features dtype), through K1 (emitting the warps) forward and K3-terms
    and K3 backward on the card."""
    return PairedCostVolume.apply(
        features, proj_matrices, depth_values, out_dtype or features.dtype, depth_chunk
    )
