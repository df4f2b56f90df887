"""Conv/BN building blocks of MVSNet (2D and 3D), NCHW / NCDHW inside.

Counterpart of the non-flat blocks of
``scene_3dreconstruction_mvsnet_tpu/models/blocks.py``. Module names follow
the reference's state-dict keys (``conv``/``bn``; ``0``/``1`` for the
transposed-conv stages), so the JAX package's exported weights load with
``strict=True``. BatchNorm is torch's kernel with flax's training
semantics: eps 1e-5, running-stat momentum 0.1 (flax's 0.9), and the running
variance updated with the biased batch variance, as flax does (torch's own
BatchNorm uses the unbiased one).

Parameters stay f32. Every conv computes in the dtype of its input (bf16 on
the fast path, f32 otherwise) with its weights cast to it, as the JAX blocks
cast params to the computation dtype; BatchNorm takes the low-precision input
with its f32 parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class _FlaxRunningVar:
    """BatchNorm whose training step updates the running variance with the
    biased batch variance, as flax's BatchNorm does
    (``scene_3dreconstruction_mvsnet_tpu/models/blocks.py:118-124``).

    torch's kernel normalises with the biased variance but adds
    ``momentum * var * n / (n - 1)`` to the running variance. The kernel
    updates a copy of the running variance (autograd keeps that copy, so the
    buffer may change after the call); the batch term is recovered from the
    copy's update and rescaled by ``(n - 1) / n``. The activation is read
    once: an explicit f32 variance of a bf16 activation would read it again
    and hold an f32 copy. Normalisation and the running-stat update run in
    f32 inside torch's kernel for bf16 input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        updated = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, updated, self.weight, self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            keep = (1.0 - self.momentum) * self.running_var  # flax: 0.9 * running var
            self.running_var.copy_((updated - keep) * ((n - 1) / n) + keep)
        return y


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxRunningVar, nn.BatchNorm3d):
    pass


def _cast(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if p is None else p.to(dtype)


def conv(module: nn.Conv2d | nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``module`` in the dtype of ``x``."""
    fn = F.conv2d if isinstance(module, nn.Conv2d) else F.conv3d
    return fn(
        x, _cast(module.weight, x.dtype), _cast(module.bias, x.dtype),
        module.stride, module.padding,
    )


class ConvBnReLU(nn.Module):
    """2D conv (no bias) + BatchNorm + optional ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, pad: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride, pad, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(conv(self.conv, x))
        return F.relu(x) if self.relu else x


class ConvBnReLU3D(nn.Module):
    """3D conv (no bias) + BatchNorm + optional ReLU on [B, C, D, H, W]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, pad: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size, stride, pad, bias=False)
        self.bn = BatchNorm3d(out_channels, eps=1e-5, momentum=0.1)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(conv(self.conv, x))
        return F.relu(x) if self.relu else x


class ConvTransposeBnReLU3D(nn.Sequential):
    """ConvTranspose3d(k=3, s=2, p=1, output_padding=1, no bias) + BatchNorm
    + ReLU, the decoder stage of CostRegNet; output spatial dims are exactly
    twice the input's. Children ``0`` and ``1`` carry the reference's keys."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(
            nn.ConvTranspose3d(in_channels, out_channels, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            BatchNorm3d(out_channels, eps=1e-5, momentum=0.1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        deconv, bn = self[0], self[1]
        x = F.conv_transpose3d(
            x, _cast(deconv.weight, x.dtype), None, deconv.stride, deconv.padding,
            deconv.output_padding,
        )
        return F.relu(bn(x))
