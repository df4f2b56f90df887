"""Depth-error metric suite.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/train/metrics.py`` (the
reference's ``utils.py:127-156``): each metric is computed per image over the
masked pixels, then averaged over the batch. ``thres{N}mm_error`` is an
error rate, the fraction of masked pixels whose absolute error exceeds N
(higher is worse); the reference's name is kept.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_reduce_sum, world_size

THRESHOLDS = (1, 2, 4, 8)


def _masked_per_image_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` over ``mask`` per image -> [B]."""
    dims = tuple(range(1, values.dim()))
    m = mask.to(values.dtype)
    return (values * m).sum(dims) / m.sum(dims).clamp_min(1.0)


def _abs_error_per_image(depth_est: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _masked_per_image_mean((depth_est - depth_gt).abs(), mask)


def _error_rate_per_image(depth_est: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor,
                          thres: float) -> torch.Tensor:
    return _masked_per_image_mean(((depth_est - depth_gt).abs() > thres).float(), mask)


def abs_depth_error(depth_est: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean absolute depth error, per image then batch-averaged."""
    return _abs_error_per_image(depth_est, depth_gt, mask).mean()


def threshold_error_rate(depth_est: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor,
                         thres: float) -> torch.Tensor:
    """Fraction of masked pixels with |err| > ``thres`` (mm), per image then
    batch-averaged."""
    return _error_rate_per_image(depth_est, depth_gt, mask, thres).mean()


def depth_metrics(depth_est: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor,
                  group=None) -> dict[str, torch.Tensor]:
    """The reference's 5-metric suite over depth maps [B, H, W]:
    ``abs_depth_error`` and ``threshold_error_rate`` at 1, 2, 4 and 8. With
    a process ``group`` each rank holds B of the global batch's rows, and
    the batch means are taken over the global batch (one collective)."""
    valid = mask > 0.5
    if group is None:
        means = [abs_depth_error(depth_est, depth_gt, valid)]
        means += [threshold_error_rate(depth_est, depth_gt, valid, t) for t in THRESHOLDS]
    else:
        per_image = [_abs_error_per_image(depth_est, depth_gt, valid)]
        per_image += [_error_rate_per_image(depth_est, depth_gt, valid, t) for t in THRESHOLDS]
        sums = all_reduce_sum(torch.stack([m.sum() for m in per_image]), group)
        means = list(sums / (depth_est.shape[0] * world_size(group)))
    return dict(zip(["abs_depth_error"] + [f"thres{t}mm_error" for t in THRESHOLDS], means))
