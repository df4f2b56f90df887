"""Depth-error metric suite.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/train/metrics.py`` (the
reference's ``utils.py:127-156``): each metric is computed per image over the
masked pixels, then averaged over the batch. ``thres{N}mm_error`` is an
error rate, the fraction of masked pixels whose absolute error exceeds N
(higher is worse); the reference's name is kept.
"""

from __future__ import annotations

import torch


def _masked_per_image_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` over ``mask`` per image -> [B]."""
    dims = tuple(range(1, values.dim()))
    m = mask.to(values.dtype)
    return (values * m).sum(dims) / m.sum(dims).clamp_min(1.0)


def depth_metrics(depth_est: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """The reference's 5-metric suite over depth maps [B, H, W]: the masked
    mean absolute depth error and the error rates above 1, 2, 4 and 8."""
    valid = mask > 0.5
    err = (depth_est - depth_gt).abs()
    out = {"abs_depth_error": _masked_per_image_mean(err, valid).mean()}
    for t in (1, 2, 4, 8):
        out[f"thres{t}mm_error"] = _masked_per_image_mean((err > t).float(), valid).mean()
    return out
