"""Softmax depth regression and photometric confidence, plain PyTorch.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/ops/regression.py``:
 - depth = sum_d softmax(cost)[d] * depth_values[d];
 - confidence = the 4-plane window sum of the probability volume along depth
   (zero padding 1 in front, 2 behind), taken at the *truncated* expected
   depth index.

This is the plain version of the softmax-regression kernel
(``ops/kernels/softmax_regression.py``), its oracle on the card and the path
a CPU tensor takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def depth_regression(prob_volume: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """prob_volume [B, D, H, W], depth_values [B, D] -> depth [B, H, W]."""
    return torch.einsum("bdhw,bd->bhw", prob_volume, depth_values)


def _window4_sum_depth(prob_volume: torch.Tensor) -> torch.Tensor:
    """Sliding sum of 4 planes along D with (1, 2) zero padding."""
    D = prob_volume.shape[1]
    padded = F.pad(prob_volume, (0, 0, 0, 0, 1, 2))
    return padded[:, 0:D] + padded[:, 1 : D + 1] + padded[:, 2 : D + 2] + padded[:, 3 : D + 3]


def photometric_confidence(prob_volume: torch.Tensor) -> torch.Tensor:
    """Probability mass in a 4-plane window around the regressed depth index:
    prob_volume [B, D, H, W] -> confidence [B, H, W]."""
    D = prob_volume.shape[1]
    prob_sum4 = _window4_sum_depth(prob_volume)
    indices = torch.arange(D, dtype=prob_volume.dtype, device=prob_volume.device)
    # truncation towards zero, as torch ``.long()`` in the reference; the
    # expectation of a non-negative index is non-negative, so trunc == floor
    depth_index = torch.einsum("bdhw,d->bhw", prob_volume, indices).long().clamp(0, D - 1)
    return torch.gather(prob_sum4, 1, depth_index[:, None])[:, 0]


def regress_depth_and_confidence(
    cost_reg: torch.Tensor, depth_values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax over depth, expectation depth and photometric confidence.

    cost_reg [B, D, H, W] regularised cost (pre-softmax logits), f32;
    depth_values [B, D] -> (depth [B, H, W], confidence [B, H, W]).
    Confidence is a diagnostic and carries no gradient.
    """
    prob_volume = torch.softmax(cost_reg, dim=1)
    depth = depth_regression(prob_volume, depth_values)
    confidence = photometric_confidence(prob_volume.detach())
    return depth, confidence
