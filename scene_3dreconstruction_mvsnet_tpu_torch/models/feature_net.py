"""FeatureNet: the 8-layer 2D CNN feature extractor.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/models/feature_net.py``
(the non-flat path): 3 -> 8 -> 8 -> (s2) 16 -> 16 -> 16 -> (s2) 32 -> 32 ->
32 channels, the last layer a plain conv with bias. Input [N, H, W, 3] ->
[N, H/4, W/4, 32], channels-last like the JAX module; NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import ConvBnReLU, conv


class FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(3, 8, 3, 1, 1)
        self.conv1 = ConvBnReLU(8, 8, 3, 1, 1)
        self.conv2 = ConvBnReLU(8, 16, 5, 2, 2)
        self.conv3 = ConvBnReLU(16, 16, 3, 1, 1)
        self.conv4 = ConvBnReLU(16, 16, 3, 1, 1)
        self.conv5 = ConvBnReLU(16, 32, 5, 2, 2)
        self.conv6 = ConvBnReLU(32, 32, 3, 1, 1)
        self.feature = nn.Conv2d(32, 32, 3, 1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] in the compute dtype -> [N, H/4, W/4, 32] (contiguous)."""
        x = x.permute(0, 3, 1, 2)
        for layer in (self.conv0, self.conv1, self.conv2, self.conv3, self.conv4,
                      self.conv5, self.conv6):
            x = layer(x)
        x = conv(self.feature, x)
        return x.permute(0, 2, 3, 1).contiguous()
