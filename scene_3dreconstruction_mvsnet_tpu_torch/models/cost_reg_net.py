"""CostRegNet: the 3D U-Net cost-volume regulariser.

Counterpart of the non-flat branch of
``scene_3dreconstruction_mvsnet_tpu/models/cost_reg_net.py``: encoder 32 ->
8 -> (s2) 16 -> 16 -> (s2) 32 -> 32 -> (s2) 64 -> 64, three
ConvTranspose3d+BN+ReLU decoder stages with additive skips, and a biased
3x3x3 conv to one channel. Input [B, D, H, W, 32] -> [B, D, H, W, 1],
channels-last like the JAX module; NCDHW inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import ConvBnReLU3D, ConvTransposeBnReLU3D, conv


class CostRegNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU3D(32, 8)
        self.conv1 = ConvBnReLU3D(8, 16, stride=2)
        self.conv2 = ConvBnReLU3D(16, 16)
        self.conv3 = ConvBnReLU3D(16, 32, stride=2)
        self.conv4 = ConvBnReLU3D(32, 32)
        self.conv5 = ConvBnReLU3D(32, 64, stride=2)
        self.conv6 = ConvBnReLU3D(64, 64)
        self.conv7 = ConvTransposeBnReLU3D(64, 32)
        self.conv9 = ConvTransposeBnReLU3D(32, 16)
        self.conv11 = ConvTransposeBnReLU3D(16, 8)
        self.prob = nn.Conv3d(8, 1, 3, stride=1, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, D, H, W, 32] in the compute dtype -> [B, D, H, W, 1]."""
        x = x.permute(0, 4, 1, 2, 3).contiguous()
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return conv(self.prob, x).permute(0, 2, 3, 4, 1)
