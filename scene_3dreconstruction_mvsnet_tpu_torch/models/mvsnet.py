"""MVSNet forward: FeatureNet -> plane-sweep variance cost volume ->
CostRegNet -> softmax regression and photometric confidence; and its
training loss.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/models/mvsnet.py`` with
``refine=False``. Inputs are channels-last as in the JAX module: imgs
[B, V, H, W, 3] (view 0 = reference view), proj_matrices [B, V, 4, 4] (K@E
at feature resolution, i.e. intrinsics / 4), depth_values [B, D].

Steps 2 and 4 go through the kernel wrappers (``ops/kernels``): CPU tensors
take the plain PyTorch versions, CUDA tensors the Hopper kernels. In
training (``model.train()``, gradients on) step 2 is the paired sweep (K1
emitting the warps forward, K3 backward) and step 4 the plain differentiable
regression, since the regression kernel has no backward; BatchNorm then
normalises with batch statistics, FeatureNet's over all B*V images.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.kernels.softmax_regression import softmax_regression
from ..ops.kernels.sweep_variance import sweep_variance
from ..ops.paired_sweep import paired_cost_volume
from ..ops.regression import regress_depth_and_confidence
from .cost_reg_net import CostRegNet
from .feature_net import FeatureNet


class MVSNet(nn.Module):
    """MVSNet without the refinement head.

    Args:
      depth_chunk: chunk size of the plain sweep's depth axis (bounds its
        memory on the CPU); the sweep kernel ignores it.
      dtype: compute dtype of the conv stacks and of the features the sweep
        samples; None is f32, ``torch.bfloat16`` the fast path. Parameters
        stay f32 and are cast per conv. The sweep accumulates in f32 and the
        regression runs in f32 whatever the dtype.
    """

    def __init__(self, depth_chunk: int | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.depth_chunk = depth_chunk
        self.dtype = dtype
        self.feature = FeatureNet()
        self.cost_regularization = CostRegNet()

    def forward(
        self, imgs: torch.Tensor, proj_matrices: torch.Tensor, depth_values: torch.Tensor
    ) -> dict[str, torch.Tensor]:
        B, V, H, W, C = imgs.shape
        if proj_matrices.shape[1] != V:
            raise ValueError(f"got {V} images but {proj_matrices.shape[1]} projection matrices")
        dtype = self.dtype or torch.float32
        depth_values = depth_values.float()

        # Step 1: feature extraction, views folded into the batch.
        feats = self.feature(imgs.reshape(B * V, H, W, C).to(dtype))
        feats = feats.reshape(B, V, H // 4, W // 4, feats.shape[-1])

        # Step 2: variance cost volume [B, D, H/4, W/4, 32] in the compute
        # dtype, accumulated in f32; differentiable through the paired sweep
        # when training.
        sweep = paired_cost_volume if self.training and torch.is_grad_enabled() else sweep_variance
        volume = sweep(
            feats, proj_matrices.float(), depth_values,
            depth_chunk=self.depth_chunk, out_dtype=dtype,
        )

        # Step 3: 3D U-Net -> [B, D, h, w] logits.
        cost_reg = self.cost_regularization(volume)[..., 0]

        # Step 4: softmax regression + confidence, in f32; the kernel is
        # inference-only, training takes the differentiable plain version.
        regress = regress_depth_and_confidence if self.training else softmax_regression
        depth, confidence = regress(cost_reg.float(), depth_values)
        return {"depth": depth, "photometric_confidence": confidence}


def mvsnet_loss(depth_est: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked smooth-L1 (beta 1) loss, the mean over the pixels with
    mask > 0.5 (at least 1): ``F.smooth_l1_loss`` over the valid pixels, as
    the JAX package's ``mvsnet_loss``."""
    valid = (mask > 0.5).to(depth_est.dtype)
    diff = (depth_est - depth_gt).abs()
    per_pixel = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    return (per_pixel * valid).sum() / valid.sum().clamp_min(1.0)


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and BatchNorm buffer of ``model`` in place from
    ``generator`` (on the model's device): conv weights He-normal over their
    fan-in, conv biases and BN shifts small, BN scales and running variances
    near 1, running means near 0, so activations stay O(1) through any depth
    of the network. Returns ``model``."""

    def draw(shape, device):
        return torch.randn(shape, generator=generator, device=device)

    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            w = module.weight
            if isinstance(module, nn.ConvTranspose3d):
                # weight [I, O, k, k, k]; at stride 2 an output sees ~1/8 of the taps
                fan_in = w.shape[0] * w[0, 0].numel() / 8
            else:
                fan_in = w[0].numel()
            w.copy_(draw(w.shape, w.device) * math.sqrt(2.0 / fan_in))
            if module.bias is not None:
                module.bias.copy_(draw(module.bias.shape, w.device) * 0.1)
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            dev = module.weight.device
            n = module.num_features
            module.weight.copy_(1.0 + 0.1 * draw(n, dev))
            module.bias.copy_(0.1 * draw(n, dev))
            module.running_mean.copy_(0.1 * draw(n, dev))
            module.running_var.copy_(1.0 + 0.1 * draw(n, dev).abs())
    return model
