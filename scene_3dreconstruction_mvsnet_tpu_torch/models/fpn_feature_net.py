"""FPNFeatureNet: CasMVSNet's feature pyramid.

Gu et al., "Cascade Cost Volume for High-Resolution Multi-View Stereo and
Stereo Matching" (CVPR, 2020, arXiv:1912.06378), ``FeatureNet(base_channels=8,
num_stage=3, arch_mode="fpn")`` of the public code
(``CasMVSNet/models/module.py``). Bottom-up, the ConvBnReLU blocks of
MVSNet's FeatureNet: ``conv0`` 3 -> 8 -> 8 (3x3), ``conv1`` 8 -> 16 (5x5,
stride 2) -> 16 -> 16, ``conv2`` 16 -> 32 (5x5, stride 2) -> 32 -> 32. Top-down:
stage 1 is ``out1`` (1x1, 32 -> 32, no bias) of conv2; f = conv2 upsampled x2
(nearest) + ``inner1`` (1x1, 16 -> 32, with bias) of conv1, stage 2 is
``out2`` (3x3, 32 -> 16, no bias) of f; f = f upsampled x2 + ``inner2`` (1x1,
8 -> 32, with bias) of conv0, stage 3 is ``out3`` (3x3, 32 -> 8, no bias) of
f. Input [N, H, W, 3] -> three channels-last maps: [N, H/4, W/4, 32],
[N, H/2, W/2, 16], [N, H, W, 8]. Module names are the public code's
state-dict keys (``conv0.0.conv.weight``, ``inner1.bias``, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import ConvBnReLU, conv


class FPNFeatureNet(nn.Module):
    out_channels = (32, 16, 8)  # stages 1, 2, 3

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Sequential(ConvBnReLU(3, 8, 3, 1, 1), ConvBnReLU(8, 8, 3, 1, 1))
        self.conv1 = nn.Sequential(ConvBnReLU(8, 16, 5, 2, 2), ConvBnReLU(16, 16, 3, 1, 1),
                                   ConvBnReLU(16, 16, 3, 1, 1))
        self.conv2 = nn.Sequential(ConvBnReLU(16, 32, 5, 2, 2), ConvBnReLU(32, 32, 3, 1, 1),
                                   ConvBnReLU(32, 32, 3, 1, 1))
        self.out1 = nn.Conv2d(32, 32, 1, bias=False)
        self.inner1 = nn.Conv2d(16, 32, 1, bias=True)
        self.inner2 = nn.Conv2d(8, 32, 1, bias=True)
        self.out2 = nn.Conv2d(32, 16, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(32, 8, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x [N, H, W, 3] in the compute dtype (H and W multiples of 4) ->
        the three stages' features, coarsest first, each channels-last and
        contiguous."""
        conv0 = self.conv0(x.permute(0, 3, 1, 2))
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        outs = [conv(self.out1, conv2)]
        f = F.interpolate(conv2, scale_factor=2, mode="nearest") + conv(self.inner1, conv1)
        outs.append(conv(self.out2, f))
        f = F.interpolate(f, scale_factor=2, mode="nearest") + conv(self.inner2, conv0)
        outs.append(conv(self.out3, f))
        return [o.permute(0, 2, 3, 1).contiguous() for o in outs]
