"""RefineNet: the residual depth refinement head.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/models/refine_net.py``,
the JAX package's working version of the reference's head (which ships
broken). The full-resolution reference image is resized bilinearly to the
depth map's size, concatenated with the depth map (4 channels), passed
through ConvBnReLU 32, 32, 32 and 1, and added to the depth map as a
residual. The last block keeps its ReLU, as in the JAX package and the
reference, so the residual is never negative.

The resize antialiases, as ``jax.image.resize(..., "bilinear")`` does when it
downsamples. The concatenated input, depth included, is cast to the compute
dtype before the first conv, as flax's ``ConvBnReLU(dtype=...)`` casts it;
the residual is added to the f32 depth.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import ConvBnReLU


class RefineNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBnReLU(4, 32)
        self.conv2 = ConvBnReLU(32, 32)
        self.conv3 = ConvBnReLU(32, 32)
        self.res = ConvBnReLU(32, 1)

    def forward(self, img: torch.Tensor, depth_init: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """img [B, H, W, 3] full resolution, depth_init [B, h, w] -> refined
        depth [B, h, w] in depth_init's dtype."""
        h, w = depth_init.shape[-2:]
        img_small = F.interpolate(img.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False,
                                  antialias=True)
        x = torch.cat([img_small, depth_init[:, None]], dim=1).to(dtype)
        for layer in (self.conv1, self.conv2, self.conv3, self.res):
            x = layer(x)
        return depth_init + x[:, 0]
