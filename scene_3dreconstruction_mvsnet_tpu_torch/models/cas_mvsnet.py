"""CasMVSNet: the three-stage cascade cost volume, inference.

Gu et al., "Cascade Cost Volume for High-Resolution Multi-View Stereo and
Stereo Matching" (CVPR, 2020, arXiv:1912.06378); the public code's
``CascadeMVSNet`` (``CasMVSNet/models/cas_mvsnet.py`` and ``module.py``) at
its defaults: ``ndepths`` (48, 32, 8), ``depth_interals_ratio`` (4, 2, 1),
the FPN feature net with 8 base channels, one CostRegNet of base 8 per stage
(``cr_base_chs`` (8, 8, 8), not shared), no refinement.

The call is MVSNet's: imgs [B, V, H, W, 3] (view 0 the reference), the K@E
projections [B, V, 4, 4] at 1/4 resolution and the D0 depth values
[B, D0]. With ``min``, ``max`` the first and last depth value and
``interval = (max - min) / D0`` (D0, not D0 - 1, as the public code):

- the FPN (``models/fpn_feature_net.py``) gives stage s's features at 1/4,
  1/2 and 1/1 resolution, 32, 16 and 8 channels;
- stage 1 sweeps N1 planes ``min + k (max - min) / (N1 - 1)``, the same for
  every pixel;
- stage s > 1 upsamples the previous stage's depth (detached) bilinearly to
  H x W (align_corners False), takes ``lo, hi = cur -+ (N_s / 2) ratio_s
  interval`` and the N_s planes ``lo + k (hi - lo) / (N_s - 1)`` per pixel,
  resized to the stage's resolution by trilinear interpolation with the
  plane count kept (align_corners False);
- each stage scales the projections' first two rows (the intrinsics' rows)
  by 1, 2, 4, sweeps the variance cost volume of its features over its
  planes (K1; per pixel from stage 2 on), regularises it with its own
  CostRegNet (C_s input channels, ``prob`` without bias) and regresses depth
  and photometric confidence (K2: the softmax expectation of the planes'
  depths, the 4-plane window at the truncated expected index).

Returns stage 3's ``depth`` and ``photometric_confidence`` [B, H, W] and,
under ``stage1`` .. ``stage3``, each stage's two maps, as the public code.

Departures from the public code, none of which changes the equations:

- the depth range and interval are computed on the device in f32, per
  sample; the public code reads the first sample's with ``.cpu()`` (three
  host syncs a request) and divides in Python's double. Nothing in the
  forward waits for the device;
- stage 1's planes go to K1 as [B, N1] (its per-plane path): the public
  code's trilinear resize of planes that are constant over the pixels
  gives back the same values exactly;
- the projections arrive as K@E at 1/4 resolution, scaled by powers of two
  per stage; the public code multiplies each stage's intrinsics into its
  extrinsics, which rounds to the same values;
- images and features are channels-last at the modules' boundaries, as
  the port's MVSNet;
- the convs, features, cost volumes and logits are in ``dtype`` (bf16 on
  the fast path; the public code is f32), while the depths, hypotheses,
  projections and the regression stay f32 at every dtype: in bf16 an
  interval of 2.65 mm at 650 mm is below one unit in the last place;
- the decoder stages of each CostRegNet carry the port's keys
  (``conv7.0``/``conv7.1``, the public code's ``conv7.conv``/``conv7.bn``):
  a published checkpoint needs that key map;
- a forward in training mode with gradients on raises: the cascade has no
  training path yet (``missing_paths``).

Spans (``utils/tracing.py``): ``casmvsnet.fpn``; ``casmvsnet.stage{s}``, the
whole stage; inside it ``casmvsnet.sweep{s}`` (K1), ``casmvsnet.costreg{s}``
and ``casmvsnet.regress{s}`` (K2).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.softmax_regression import softmax_regression
from ..ops.kernels.sweep_variance import sweep_variance
from ..utils import tracing
from .cost_reg_net import CostRegNet
from .fpn_feature_net import FPNFeatureNet


def depth_range(depth_values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """depth_values [B, D0] f32 -> (min, max, interval), each [B]:
    the first and last value and (max - min) / D0."""
    lo, hi = depth_values[:, 0], depth_values[:, -1]
    return lo, hi, (hi - lo) / depth_values.shape[1]


def uniform_planes(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` planes from ``lo`` to ``hi`` [B] -> [B, n]: lo + k (hi - lo) / (n - 1)."""
    k = torch.arange(n, dtype=lo.dtype, device=lo.device)
    return lo[:, None] + k[None] * ((hi - lo) / (n - 1))[:, None]


def pixel_planes(prev_depth: torch.Tensor, interval: torch.Tensor, n: int, ratio: float,
                 full_hw: tuple[int, int], hw: tuple[int, int]) -> torch.Tensor:
    """A later stage's planes: prev_depth [B, h', w'] (the previous stage's,
    detached), interval [B] -> [B, n, h, w] f32. The depth is upsampled
    bilinearly to ``full_hw``, the n planes span cur -+ (n / 2) ratio
    interval there, and the planes are resized to ``hw`` trilinearly, the
    plane count kept (align_corners False throughout)."""
    cur = F.interpolate(prev_depth.detach()[:, None], size=full_hw, mode="bilinear", align_corners=False)[:, 0]
    half = (interval * ratio * (n / 2))[:, None, None]
    lo, hi = cur - half, cur + half
    k = torch.arange(n, dtype=cur.dtype, device=cur.device)[None, :, None, None]
    planes = lo[:, None] + k * ((hi - lo) / (n - 1))[:, None]  # [B, n, H, W]
    return F.interpolate(planes[:, None], size=(n, *hw), mode="trilinear", align_corners=False)[:, 0]


def stage_projection(proj_matrices: torch.Tensor, scale: int) -> torch.Tensor:
    """K@E at 1/4 resolution [B, V, 4, 4] -> at ``scale`` x that resolution:
    the first two rows (the intrinsics' rows) times ``scale``."""
    if scale == 1:
        return proj_matrices
    out = proj_matrices.clone()
    out[..., :2, :] *= scale
    return out


class CasMVSNet(nn.Module):
    """CasMVSNet for inference (see the module's docstring).

    Args:
      dtype: compute dtype of the convs, features, cost volumes and logits;
        None is f32, ``torch.bfloat16`` the fast path. Parameters stay f32.
      ndepths: each stage's plane count.
      depth_interval_ratio: each stage's plane spacing in units of the input
        interval (stage 1's is not used: its planes span the whole range).
    """

    # the ROADMAP.md item that plans each path this model lacks
    missing_paths = {"train": "ROADMAP.md, Queue 4 item 2: cascade training",
                     "eval": "ROADMAP.md, Queue 4 item 1: eval_cli --model casmvsnet"}

    def __init__(self, dtype: torch.dtype | None = None, ndepths=(48, 32, 8), depth_interval_ratio=(4, 2, 1)):
        super().__init__()
        if len(ndepths) != 3 or len(depth_interval_ratio) != 3:
            raise ValueError(f"the FPN gives 3 stages; got ndepths {ndepths}, ratios {depth_interval_ratio}")
        self.dtype = dtype
        self.ndepths = tuple(ndepths)
        self.depth_interval_ratio = tuple(depth_interval_ratio)
        self.feature = FPNFeatureNet()
        self.cost_regularization = nn.ModuleList(
            CostRegNet(in_channels=c, prob_bias=False) for c in FPNFeatureNet.out_channels)

    def forward(self, imgs: torch.Tensor, proj_matrices: torch.Tensor,
                depth_values: torch.Tensor) -> dict[str, torch.Tensor | dict[str, torch.Tensor]]:
        if self.training and torch.is_grad_enabled():
            raise NotImplementedError("CasMVSNet has no training path yet: per-pixel K1-emit and K3, the "
                                      "three-stage loss and multi-scale ground truth "
                                      f"({self.missing_paths['train']})")
        B, V, H, W, C = imgs.shape
        if proj_matrices.shape[1] != V:
            raise ValueError(f"got {V} images but {proj_matrices.shape[1]} projection matrices")
        dtype = self.dtype or torch.float32
        proj_matrices = proj_matrices.float()
        lo, hi, interval = depth_range(depth_values.float())
        with tracing.span("casmvsnet.fpn"):
            feats = self.feature(imgs.reshape(B * V, H, W, C).to(dtype))
        outputs: dict = {}
        depth = None
        for s, (n, ratio, f) in enumerate(zip(self.ndepths, self.depth_interval_ratio, feats)):
            with tracing.span(f"casmvsnet.stage{s + 1}"):
                h, w = f.shape[1:3]
                f = f.reshape(B, V, h, w, f.shape[-1])
                proj = stage_projection(proj_matrices, 2 ** s)
                planes = (uniform_planes(lo, hi, n) if depth is None
                          else pixel_planes(depth, interval, n, ratio, (H, W), (h, w)))
                with tracing.span(f"casmvsnet.sweep{s + 1}"):
                    volume = sweep_variance(f, proj, planes, out_dtype=dtype)
                with tracing.span(f"casmvsnet.costreg{s + 1}"):
                    logits = self.cost_regularization[s](volume)[..., 0]
                with tracing.span(f"casmvsnet.regress{s + 1}"):
                    depth, confidence = softmax_regression(logits, planes)
            outputs[f"stage{s + 1}"] = {"depth": depth, "photometric_confidence": confidence}
        outputs.update(outputs[f"stage{len(self.ndepths)}"])
        return outputs
