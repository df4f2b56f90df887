"""MVSNet forward: FeatureNet -> plane-sweep variance cost volume ->
CostRegNet -> softmax regression and photometric confidence; and its
training loss.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/models/mvsnet.py``,
refinement head included (``refine``). Inputs are channels-last as in the JAX
module: imgs [B, V, H, W, 3] (view 0 = reference view), proj_matrices
[B, V, 4, 4] (K@E at feature resolution, i.e. intrinsics / 4), depth_values
[B, D].

Steps 2 and 4, and with ``fused_conv0`` step 3's first conv, go through the
kernel wrappers (``ops/kernels``): CPU tensors take the plain PyTorch
versions, CUDA tensors the Hopper kernels. In
training (``model.train()``, gradients on) step 2 is the paired sweep (K1
emitting the warps forward, K3 backward) and step 4 the plain differentiable
regression, since the regression kernel has no backward; BatchNorm then
normalises with batch statistics, FeatureNet's over all B*V images.

With ``volume_sharding`` (the JAX module's constraint of the volume to
``P('data', 'sweep')``) the depth planes are split over the ranks of a sweep
group: each rank runs FeatureNet whole, sweeps and regularises its slice of
the planes, and the [B, D/S, h, w] logits are gathered over the group before
the regression, so the softmax, the expectation and the 4-plane confidence
window (which can straddle two slices) see every plane; RefineNet runs on
the gathered result. Every rank of the group returns the same outputs.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.kernels.softmax_regression import softmax_regression
from ..ops.kernels.sweep_variance import sweep_variance
from ..ops.paired_sweep import paired_cost_volume
from ..ops.regression import regress_depth_and_confidence
from ..parallel.collectives import all_reduce_sum
from ..parallel.halo import gather_depth
from ..utils import tracing
from .blocks import _FlaxRunningVar
from .cost_reg_net import CostRegNet
from .feature_net import FeatureNet
from .refine_net import RefineNet


class MVSNet(nn.Module):
    """MVSNet.

    Args:
      refine: add the RefineNet residual head (``refine_network``), whose
        output is ``refined_depth`` beside ``depth``; off by default, as in
        the reference.
      depth_chunk: chunk size of the plain sweep's depth axis (bounds its
        memory on the CPU); the sweep kernel ignores it.
      dtype: compute dtype of the conv stacks and of the features the sweep
        samples; None is f32, ``torch.bfloat16`` the fast path. Parameters
        stay f32 and are cast per conv. The sweep accumulates in f32 and the
        regression runs in f32 whatever the dtype (at eval on the card the
        regression kernel converts the logits as it reads them).
      fused_conv0: with ``dtype=torch.bfloat16``, run CostRegNet's conv0 +
        BatchNorm + ReLU through the fused kernel K4 at eval (the JAX
        module's ``pallas_conv0``); training and f32 keep the module conv0.
      remat: in training, keep only the inputs of the sweep and of
        CostRegNet and recompute each in the backward
        (``torch.utils.checkpoint``), as the JAX module's ``remat``
        (``jax.checkpoint`` of the sweep, ``nn.remat(CostRegNet)``): the
        emitted warps and the U-Net's activations are not held from the
        forward to the backward, and the sweep kernel K1 runs again in the
        backward. The recompute updates no BatchNorm buffer.
      volume_sharding: a ``parallel.VolumeSharding``: split the depth planes
        over its sweep group (D must be a multiple of 8 x its ranks). With
        ``remat``, the recompute of this rank's CostRegNet runs its halo
        exchanges and BatchNorm reductions again inside the backward; every
        rank runs the same backward graph, so the collectives stay matched.
    """

    def __init__(self, refine: bool = False, depth_chunk: int | None = None, dtype: torch.dtype | None = None,
                 fused_conv0: bool = False, remat: bool = False, volume_sharding=None):
        super().__init__()
        self.depth_chunk = depth_chunk
        self.dtype = dtype
        self.remat = remat
        self.volume_sharding = volume_sharding
        self.feature = FeatureNet()
        self.cost_regularization = CostRegNet(fused_conv0=fused_conv0)
        self.refine_network = RefineNet() if refine else None

    def forward(
        self, imgs: torch.Tensor, proj_matrices: torch.Tensor, depth_values: torch.Tensor
    ) -> dict[str, torch.Tensor]:
        B, V, H, W, C = imgs.shape
        if proj_matrices.shape[1] != V:
            raise ValueError(f"got {V} images but {proj_matrices.shape[1]} projection matrices")
        dtype = self.dtype or torch.float32
        depth_values = depth_values.float()
        D = depth_values.shape[1]

        # Step 1: feature extraction, views folded into the batch.
        feats = self.feature(imgs.reshape(B * V, H, W, C).to(dtype))
        feats = feats.reshape(B, V, H // 4, W // 4, feats.shape[-1])

        # Step 2: variance cost volume [B, D, H/4, W/4, 32] in the compute
        # dtype, accumulated in f32; differentiable through the paired sweep
        # when training. Split: this rank's planes only (contiguous: the
        # kernel reads the depth values through a raw pointer).
        split = self.volume_sharding
        planes = depth_values if split is None else depth_values[:, split.depth_slice(D)].contiguous()
        training = self.training and torch.is_grad_enabled()
        sweep = paired_cost_volume if training else sweep_variance
        remat = self._rematerialised if self.remat and training else lambda fn, *args: fn(*args)
        volume = remat(
            lambda f, p, d: sweep(f, p, d, depth_chunk=self.depth_chunk, out_dtype=dtype),
            feats, proj_matrices.float(), planes,
        )

        # Step 3: 3D U-Net -> [B, D, h, w] logits (split: this rank's planes,
        # then every rank's, gathered over the sweep group).
        cost_reg = remat(self._cost_logits, volume, split)[..., 0]
        if split is not None:
            cost_reg = gather_depth(cost_reg, 1, split.group)

        # Step 4: softmax regression + confidence, in f32. The kernel is
        # inference-only and reads the logits in the compute dtype (no cast
        # before it); training takes the differentiable plain version.
        if self.training:
            depth, confidence = regress_depth_and_confidence(cost_reg.float(), depth_values)
        else:
            depth, confidence = softmax_regression(cost_reg, depth_values)
        outputs = {"depth": depth, "photometric_confidence": confidence}
        if self.refine_network is not None:
            outputs["refined_depth"] = self.refine_network(imgs[:, 0], depth, dtype)
        return outputs

    def _cost_logits(self, volume: torch.Tensor, split) -> torch.Tensor:
        """CostRegNet on the volume, the ``mvsnet.costreg`` span
        (``utils/tracing.py``). With ``remat`` the backward recomputes it, so
        the span opens again there, inside ``train.backward``. The split's
        gather is outside it."""
        with tracing.span("mvsnet.costreg"):
            return self.cost_regularization(volume, split)

    def _rematerialised(self, fn, *args):
        """``fn(*args)``, its intermediates recomputed in the backward; the
        recompute leaves the BatchNorm buffers alone (flax keeps the
        forward's ``batch_stats`` and discards the recompute's)."""
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), _recomputing(self)))


@contextlib.contextmanager
def _recomputing(model: nn.Module):
    norms = [m for m in model.modules() if isinstance(m, _FlaxRunningVar)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def mvsnet_loss(depth_est: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """Masked smooth-L1 (beta 1) loss, the mean over the pixels with
    mask > 0.5 (at least 1): ``F.smooth_l1_loss`` over the valid pixels, as
    the JAX package's ``mvsnet_loss``.

    With a process ``group``, each rank holds its rows of the global batch
    and returns its share of the global masked mean: its masked sum over the
    global valid count. The shares sum to the loss of the whole batch (the
    mean of the ranks' own means would weigh their pixels unequally)."""
    valid = (mask > 0.5).to(depth_est.dtype)
    diff = (depth_est - depth_gt).abs()
    per_pixel = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    count = valid.sum()
    if group is not None:
        count = all_reduce_sum(count.detach(), group)
    return (per_pixel * valid).sum() / count.clamp_min(1.0)


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
