"""CasMVSNet in plain PyTorch and float32: the benchmark's reference for the
cascade, and the tier-1 tests' too.

Written from Gu et al. 2020 (arXiv:1912.06378) and the public code's layer
list and equations (``CasMVSNet/models/cas_mvsnet.py``, ``module.py``), with
nothing of the port: the FPN feature net (8 base channels; 32, 16 and 8
channels at 1/4, 1/2 and 1/1 resolution), three stages of 48, 32 and 8
planes at interval ratios 4, 2 and 1, each a variance cost volume of the
views warped onto its planes with ``F.grid_sample``, its own CostRegNet
(MVSNet's U-Net with the stage's input width, ``prob`` without bias), the
softmax depth expectation and MVSNet's photometric confidence. The depth
range is the first and last of the D0 depth values, the interval
(max - min) / D0. Stage 1's planes span the range; a later stage's are
``cur -+ (N / 2) ratio interval`` around the previous stage's depth
upsampled bilinearly to the image, built there for every pixel and resized
to the stage's resolution trilinearly, as the public code builds them (stage
1's too: repeated over the image, then resized).

Module and parameter names are the port's, so one state dict loads into
this module and into the port's ``CasMVSNet`` with ``strict=True``; the FPN's
keys are the public code's, the decoder stages of each CostRegNet are
``conv7.0``/``conv7.1`` where the public code has ``conv7.conv``/``conv7.bn``.

Departures, each also the port's: images and features are channels-last at
the module's boundary; the projections arrive as K@E at 1/4 resolution and
each stage scales their first two rows by 1, 2 or 4; the depth range and
interval are f32 tensors per sample (the public code reads the first
sample's as Python floats).

``rounding`` (``precision.py``) rounds every conv's input and weight, each
cost volume and each stage's logits: the control. ``fault`` puts one of
``FAULTS`` in, for the readings that a correctness limit must catch:
``bf16_hypotheses`` (each stage's planes rounded to bfloat16),
``uniform_planes`` (stages 2 and 3 on planes spanning the whole range, as
stage 1's, in place of the per-pixel planes) and ``nearest_upsample`` (the
previous depth upsampled by nearest neighbour, not bilinearly).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import mvsnet as ref_mvsnet
from .mvsnet import ConvBnReLU, Rounding, _r

NDEPTHS = (48, 32, 8)
RATIOS = (4, 2, 1)
FAULTS = ("bf16_hypotheses", "uniform_planes", "nearest_upsample")


class FPNFeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = nn.Sequential(ConvBnReLU(3, 8), ConvBnReLU(8, 8))
        self.conv1 = nn.Sequential(ConvBnReLU(8, 16, 5, 2, 2), ConvBnReLU(16, 16), ConvBnReLU(16, 16))
        self.conv2 = nn.Sequential(ConvBnReLU(16, 32, 5, 2, 2), ConvBnReLU(32, 32), ConvBnReLU(32, 32))
        self.out1 = nn.Conv2d(32, 32, 1, bias=False)
        self.inner1 = nn.Conv2d(16, 32, 1, bias=True)
        self.inner2 = nn.Conv2d(8, 32, 1, bias=True)
        self.out2 = nn.Conv2d(32, 16, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(32, 8, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor, rounding: Rounding = None) -> list[torch.Tensor]:
        """[N, 3, H, W] -> [N, 32, H/4, W/4], [N, 16, H/2, W/2], [N, 8, H, W]."""
        def run(seq, y):
            for layer in seq:
                y = layer(y, rounding)
            return y

        def conv(m, y):
            return F.conv2d(_r(y, rounding), _r(m.weight, rounding), m.bias, 1, m.padding)

        conv0 = run(self.conv0, x)
        conv1 = run(self.conv1, conv0)
        conv2 = run(self.conv2, conv1)
        f = F.interpolate(conv2, scale_factor=2, mode="nearest") + conv(self.inner1, conv1)
        stage2 = conv(self.out2, f)
        f = F.interpolate(f, scale_factor=2, mode="nearest") + conv(self.inner2, conv0)
        return [conv(self.out1, conv2), stage2, conv(self.out3, f)]


class CostRegNet(ref_mvsnet.CostRegNet):
    """MVSNet's CostRegNet with ``in_channels`` input channels and ``prob``
    without bias."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv0 = ConvBnReLU(in_channels, 8, dims=3)
        self.prob = nn.Conv3d(8, 1, 3, stride=1, padding=1, bias=False)


def homography_grid(src_proj: torch.Tensor, ref_proj: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """``mvsnet.homography_grid`` with a depth per plane and pixel: the
    reference pixel (x, y) at depth planes[b, k, y, x] -> [B, D * h, w, 2]."""
    B, D, h, w = planes.shape
    proj = src_proj @ torch.linalg.inv(ref_proj)
    rot, trans = proj[:, :3, :3], proj[:, :3, 3]
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=planes.device),
                          torch.arange(w, dtype=torch.float32, device=planes.device), indexing="ij")
    xyz = torch.stack([x.reshape(-1), y.reshape(-1), torch.ones(h * w, device=x.device)])  # [3, hw]
    pts = (rot @ xyz)[:, :, None, :] * planes.reshape(B, 1, D, h * w) + trans[:, :, None, None]  # [B, 3, D, hw]
    gx = pts[:, 0] / pts[:, 2] / ((w - 1) / 2.0) - 1.0
    gy = pts[:, 1] / pts[:, 2] / ((h - 1) / 2.0) - 1.0
    return torch.stack([gx, gy], dim=-1).reshape(B, D * h, w, 2)


def variance_volume(feats: torch.Tensor, proj: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """feats [B, V, C, h, w] (view 0 the reference), proj [B, V, 4, 4],
    planes [B, D, h, w] -> the variance over the views [B, C, D, h, w]."""
    B, V, C, h, w = feats.shape
    D = planes.shape[1]
    ref = feats[:, 0, :, None]
    total, squares = ref.expand(B, C, D, h, w), (ref * ref).expand(B, C, D, h, w)
    for v in range(1, V):
        warped = F.grid_sample(feats[:, v], homography_grid(proj[:, v], proj[:, 0], planes), mode="bilinear",
                               padding_mode="zeros", align_corners=False).reshape(B, C, D, h, w)
        total = total + warped
        squares = squares + warped * warped
    mean = total / V
    return squares / V - mean * mean


def regress(logits: torch.Tensor, planes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [B, D, h, w], planes [B, D, h, w] -> (depth, photometric
    confidence) [B, h, w]; the confidence (over plane indices) is MVSNet's."""
    depth = (torch.softmax(logits, dim=1) * planes).sum(1)
    return depth, ref_mvsnet.regress(logits, planes[:, :, 0, 0])[1]


def depth_samples(cur: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, interval: torch.Tensor, n: int,
                  ratio: float, full_hw: tuple[int, int]) -> torch.Tensor:
    """The public code's ``get_depth_range_samples`` at the image's size
    -> [B, n, H, W]: with no previous depth (``cur`` None) n planes from lo
    to hi [B], repeated over the pixels; else n planes spanning
    cur -+ (n / 2) ratio interval for each pixel of cur [B, H, W]."""
    k = torch.arange(n, dtype=torch.float32, device=lo.device)
    if cur is None:
        planes = lo[:, None] + k[None] * ((hi - lo) / (n - 1))[:, None]
        return planes[:, :, None, None].repeat(1, 1, *full_hw)
    half = (interval * ratio * (n / 2))[:, None, None]
    low, high = cur - half, cur + half
    return low[:, None] + k[None, :, None, None] * ((high - low) / (n - 1))[:, None]


class CasMVSNet(nn.Module):
    def __init__(self, ndepths=NDEPTHS, ratios=RATIOS):
        super().__init__()
        self.ndepths, self.ratios = tuple(ndepths), tuple(ratios)
        self.feature = FPNFeatureNet()
        self.cost_regularization = nn.ModuleList(CostRegNet(c) for c in (32, 16, 8))

    def forward(self, imgs: torch.Tensor, proj: torch.Tensor, depth_values: torch.Tensor,
                rounding: Rounding = None, fault: str | None = None) -> dict:
        """imgs [B, V, H, W, 3] in [0, 1], proj [B, V, 4, 4] (1/4
        resolution), depth_values [B, D0] -> {'depth', 'photometric_confidence'
        (stage 3's, [B, H, W]), 'stage1' .. 'stage3': each stage's two}."""
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
        B, V, H, W, _ = imgs.shape
        feats = self.feature(imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2), rounding)
        lo, hi = depth_values[:, 0], depth_values[:, -1]
        interval = (hi - lo) / depth_values.shape[1]
        out, depth = {}, None
        for s, (n, ratio, f) in enumerate(zip(self.ndepths, self.ratios, feats)):
            h, w = f.shape[2:]
            cur = None
            if depth is not None and fault != "uniform_planes":
                mode = "nearest" if fault == "nearest_upsample" else "bilinear"
                cur = F.interpolate(depth[:, None], size=(H, W), mode=mode,
                                    **({} if mode == "nearest" else {"align_corners": False}))[:, 0]
            planes = depth_samples(cur, lo, hi, interval, n, ratio, (H, W))
            planes = F.interpolate(planes[:, None], size=(n, h, w), mode="trilinear", align_corners=False)[:, 0]
            if fault == "bf16_hypotheses":
                planes = planes.to(torch.bfloat16).float()
            stage_proj = proj.clone()
            stage_proj[..., :2, :] *= 2 ** s
            volume = _r(variance_volume(f.reshape(B, V, *f.shape[1:]), stage_proj, planes), rounding)
            logits = _r(self.cost_regularization[s](volume, rounding), rounding)
            depth, confidence = regress(logits, planes)
            out[f"stage{s + 1}"] = {"depth": depth, "photometric_confidence": confidence}
        out.update(out[f"stage{len(self.ndepths)}"])
        return out
