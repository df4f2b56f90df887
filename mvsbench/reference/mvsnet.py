"""MVSNet in plain PyTorch and float32: the benchmark's reference.

Written from the description of Yao et al. 2018 (arXiv:1804.02505) and the
public PyTorch reimplementation's layer list, with nothing of the port:
FeatureNet (8 conv layers, 3 -> 32 channels at 1/4 resolution), the
differentiable homography warp of each source view's features onto the
reference view's depth planes (``F.grid_sample``), the variance cost volume
over the views, CostRegNet (a 3D U-Net, 32 -> 8 ... 64 -> 1 channel), the
softmax depth expectation, the photometric confidence (the probability in a
4-plane window around the expected plane index) and the masked smooth-L1
loss. Module and parameter names are the public implementation's
state-dict keys, so one dict of weights loads into this module and into the
port's.

Departures, each also the port's: images and features are channels-last at
the module's boundary; BatchNorm's eps is 1e-5 and its momentum 0.1.

``rounding`` (``mvsbench/reference/precision.py``) rounds every conv's
input and weight, the cost volume and the logits to a lower precision, with
gradients passed straight through: the controls. The reference itself runs
with it unset, in f32 with TF32 off (``precision.exact``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

Rounding = Callable[[torch.Tensor], torch.Tensor] | None


def _r(x: torch.Tensor, rounding: Rounding) -> torch.Tensor:
    return x if rounding is None else rounding(x)


class ConvBnReLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, pad: int = 1, dims: int = 2):
        super().__init__()
        conv, bn = (nn.Conv2d, nn.BatchNorm2d) if dims == 2 else (nn.Conv3d, nn.BatchNorm3d)
        self.conv = conv(cin, cout, k, stride, pad, bias=False)
        self.bn = bn(cout, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, rounding: Rounding = None) -> torch.Tensor:
        conv = F.conv2d if isinstance(self.conv, nn.Conv2d) else F.conv3d
        y = conv(_r(x, rounding), _r(self.conv.weight, rounding), None, self.conv.stride, self.conv.padding)
        return F.relu(self.bn(y))


class Deconv(nn.Sequential):
    """ConvTranspose3d (k 3, stride 2, padding 1, output padding 1) +
    BatchNorm3d + ReLU; children ``0`` and ``1``."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1, output_padding=1, bias=False),
                         nn.BatchNorm3d(cout, eps=1e-5, momentum=0.1))

    def forward(self, x: torch.Tensor, rounding: Rounding = None) -> torch.Tensor:
        deconv = self[0]
        y = F.conv_transpose3d(_r(x, rounding), _r(deconv.weight, rounding), None, 2, 1, 1)
        return F.relu(self[1](y))


class FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(3, 8)
        self.conv1 = ConvBnReLU(8, 8)
        self.conv2 = ConvBnReLU(8, 16, 5, 2, 2)
        self.conv3 = ConvBnReLU(16, 16)
        self.conv4 = ConvBnReLU(16, 16)
        self.conv5 = ConvBnReLU(16, 32, 5, 2, 2)
        self.conv6 = ConvBnReLU(32, 32)
        self.feature = nn.Conv2d(32, 32, 3, 1, 1, bias=True)

    def forward(self, x: torch.Tensor, rounding: Rounding = None) -> torch.Tensor:
        """[N, 3, H, W] -> [N, 32, H/4, W/4]."""
        for layer in (self.conv0, self.conv1, self.conv2, self.conv3, self.conv4, self.conv5, self.conv6):
            x = layer(x, rounding)
        return F.conv2d(_r(x, rounding), _r(self.feature.weight, rounding), self.feature.bias, 1, 1)


class CostRegNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(32, 8, dims=3)
        self.conv1 = ConvBnReLU(8, 16, stride=2, dims=3)
        self.conv2 = ConvBnReLU(16, 16, dims=3)
        self.conv3 = ConvBnReLU(16, 32, stride=2, dims=3)
        self.conv4 = ConvBnReLU(32, 32, dims=3)
        self.conv5 = ConvBnReLU(32, 64, stride=2, dims=3)
        self.conv6 = ConvBnReLU(64, 64, dims=3)
        self.conv7 = Deconv(64, 32)
        self.conv9 = Deconv(32, 16)
        self.conv11 = Deconv(16, 8)
        self.prob = nn.Conv3d(8, 1, 3, stride=1, padding=1, bias=True)

    def forward(self, x: torch.Tensor, rounding: Rounding = None) -> torch.Tensor:
        """[B, 32, D, h, w] -> [B, D, h, w] logits."""
        conv0 = self.conv0(x, rounding)
        conv2 = self.conv2(self.conv1(conv0, rounding), rounding)
        conv4 = self.conv4(self.conv3(conv2, rounding), rounding)
        x = self.conv6(self.conv5(conv4, rounding), rounding)
        x = conv4 + self.conv7(x, rounding)
        x = conv2 + self.conv9(x, rounding)
        x = conv0 + self.conv11(x, rounding)
        return F.conv3d(_r(x, rounding), _r(self.prob.weight, rounding), self.prob.bias, 1, 1)[:, 0]


def homography_grid(src_proj: torch.Tensor, ref_proj: torch.Tensor, depth_values: torch.Tensor,
                    h: int, w: int) -> torch.Tensor:
    """The sampling grid of a source view over the reference view's planes:
    the reference pixel (x, y) (integer corners) at depth d lands at
    P (x d, y d, d, 1) in the source, P = src_proj @ inv(ref_proj), then the
    perspective divide; normalised by (W - 1) / 2 as the public
    implementation does and sampled with ``align_corners=False``.
    -> [B, D * h, w, 2]."""
    B, D = depth_values.shape
    proj = src_proj @ torch.linalg.inv(ref_proj)
    rot, trans = proj[:, :3, :3], proj[:, :3, 3]
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=depth_values.device),
                          torch.arange(w, dtype=torch.float32, device=depth_values.device), indexing="ij")
    xyz = torch.stack([x.reshape(-1), y.reshape(-1), torch.ones(h * w, device=x.device)])  # [3, hw]
    pts = (rot @ xyz)[:, :, None, :] * depth_values[:, None, :, None] + trans[:, :, None, None]  # [B, 3, D, hw]
    gx = pts[:, 0] / pts[:, 2] / ((w - 1) / 2.0) - 1.0
    gy = pts[:, 1] / pts[:, 2] / ((h - 1) / 2.0) - 1.0
    return torch.stack([gx, gy], dim=-1).reshape(B, D * h, w, 2)


def variance_volume(feats: torch.Tensor, proj: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """feats [B, V, C, h, w] (view 0 the reference), proj [B, V, 4, 4],
    depth_values [B, D] -> the variance over the views [B, C, D, h, w]."""
    B, V, C, h, w = feats.shape
    D = depth_values.shape[1]
    ref = feats[:, 0, :, None]  # [B, C, 1, h, w]
    total, squares = ref.expand(B, C, D, h, w), (ref * ref).expand(B, C, D, h, w)
    for v in range(1, V):
        grid = homography_grid(proj[:, v], proj[:, 0], depth_values, h, w)
        warped = F.grid_sample(feats[:, v], grid, mode="bilinear", padding_mode="zeros",
                               align_corners=False).reshape(B, C, D, h, w)
        total = total + warped
        squares = squares + warped * warped
    mean = total / V
    return squares / V - mean * mean


def regress(logits: torch.Tensor, depth_values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [B, D, h, w] -> (depth, photometric confidence), each [B, h, w]."""
    prob = torch.softmax(logits, dim=1)
    depth = (prob * depth_values[:, :, None, None]).sum(1)
    with torch.no_grad():
        D = prob.shape[1]
        padded = F.pad(prob, (0, 0, 0, 0, 1, 2))
        window = padded[:, :D] + padded[:, 1:D + 1] + padded[:, 2:D + 2] + padded[:, 3:D + 3]
        index = (prob * torch.arange(D, dtype=prob.dtype, device=prob.device)[:, None, None]).sum(1)
        index = index.long().clamp(0, D - 1)
        confidence = torch.gather(window, 1, index[:, None])[:, 0]
    return depth, confidence


class MVSNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.feature = FeatureNet()
        self.cost_regularization = CostRegNet()

    def forward(self, imgs: torch.Tensor, proj: torch.Tensor, depth_values: torch.Tensor,
                rounding: Rounding = None) -> tuple[torch.Tensor, torch.Tensor]:
        """imgs [B, V, H, W, 3] in [0, 1], proj [B, V, 4, 4] (feature
        resolution), depth_values [B, D] -> (depth, confidence) [B, H/4, W/4]."""
        B, V, H, W, _ = imgs.shape
        feats = self.feature(imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2), rounding)
        feats = feats.reshape(B, V, *feats.shape[1:])
        volume = _r(variance_volume(feats, proj, depth_values), rounding)
        logits = _r(self.cost_regularization(volume, rounding), rounding)
        return regress(logits, depth_values)


def masked_smooth_l1(depth: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 (beta 1) over the pixels with mask > 0.5, their mean."""
    valid = mask > 0.5
    return F.smooth_l1_loss(depth[valid], gt[valid], reduction="mean")
