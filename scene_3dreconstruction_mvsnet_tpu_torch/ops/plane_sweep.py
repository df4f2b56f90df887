"""Streaming plane-sweep variance cost volume, plain PyTorch.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/ops/plane_sweep.py``
(its XLA path). Var = E[x^2] - E[x]^2 over views is an additive reduction:
the f32 running sum and sum of squares take one warped view at a time, so
only one warped volume is live. The accumulators are updated in place to
keep that bound. This is the plain version of the sweep-variance kernel
(``ops/kernels/sweep_variance.py``), its oracle on the card and the path a
CPU tensor takes; ``emit_warps`` is the plain version of the kernel's
training mode, which also returns each source view's warped volume.
"""

from __future__ import annotations

import torch

from .sampling import warp_src_feature_ncdhw


def _sweep_variance_chunk(
    features: torch.Tensor,
    proj_matrices: torch.Tensor,
    depth_chunk: torch.Tensor,
    out_dtype: torch.dtype,
    emit_warps: bool,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """features [B, V, H, W, C] (view 0 = reference), proj [B, V, 4, 4],
    depth_chunk [B, Dc] (or [B, Dc, H, W]) -> (variance [B, Dc, H, W, C] in
    ``out_dtype``, the source views' warped volumes [B, V-1, Dc, H, W, C] in
    ``out_dtype`` when ``emit_warps``, else None)."""
    B, V, H, W, C = features.shape
    Dc = depth_chunk.shape[1]
    ref_proj = proj_matrices[:, 0]

    # the reference view enters the accumulators unwarped, broadcast over depth
    ref = features[:, 0].permute(0, 3, 1, 2).float()[:, :, None]  # [B, C, 1, H, W]
    vol_sum = ref.expand(B, C, Dc, H, W).clone()
    vol_sq = (ref * ref).expand(B, C, Dc, H, W).clone()
    warps = []
    for v in range(1, V):
        warped = warp_src_feature_ncdhw(features[:, v], proj_matrices[:, v], ref_proj, depth_chunk)
        vol_sum += warped
        vol_sq += warped * warped
        if emit_warps:
            warps.append(warped.permute(0, 2, 3, 4, 1).to(out_dtype))
        del warped
    inv_v = 1.0 / V
    mean = vol_sum.mul_(inv_v)
    var = vol_sq.mul_(inv_v).sub_(mean * mean)
    var = var.permute(0, 2, 3, 4, 1).contiguous().to(out_dtype)
    return var, torch.stack(warps, dim=1) if emit_warps else None


def cost_volume_variance(
    features: torch.Tensor,
    proj_matrices: torch.Tensor,
    depth_values: torch.Tensor,
    depth_chunk: int | None = None,
    out_dtype: torch.dtype | None = None,
    emit_warps: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Variance cost volume over views.

    Args:
      features: [B, V, H, W, C] per-view feature maps; view 0 is the reference.
      proj_matrices: [B, V, 4, 4] K@E per view (f32).
      depth_values: [B, D] depth hypotheses (f32), or one per plane and
        pixel [B, D, H, W].
      depth_chunk: if set (must divide D), sweep the depth planes in chunks of
        this size to bound peak memory; None sweeps all planes at once.
      out_dtype: dtype of the result; None means the features dtype.
      emit_warps: also return each source view's warped volume.

    Returns [B, D, H, W, C]; sampling and the sum/sum^2 accumulators are f32
    whatever the features dtype. With ``emit_warps``, returns (that volume,
    warps [B, V-1, D, H, W, C]); both in ``out_dtype``.
    """
    D = depth_values.shape[1]
    out_dtype = out_dtype or features.dtype
    if depth_chunk is None or depth_chunk >= D:
        depth_chunk = D
    if D % depth_chunk != 0:
        raise ValueError(f"depth_chunk {depth_chunk} must divide D={D}")
    chunks = [
        _sweep_variance_chunk(
            features, proj_matrices, depth_values[:, i : i + depth_chunk], out_dtype, emit_warps
        )
        for i in range(0, D, depth_chunk)
    ]
    var = chunks[0][0] if len(chunks) == 1 else torch.cat([c[0] for c in chunks], dim=1)
    if not emit_warps:
        return var
    return var, chunks[0][1] if len(chunks) == 1 else torch.cat([c[1] for c in chunks], dim=2)
