"""The optimizer and the train/eval steps.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/train/state.py``: a train
step is the forward in training mode (BatchNorm on batch statistics, its
running statistics updated), the masked smooth-L1 loss, Adam with the
per-step MultiStepLR schedule, and the metric suite, all on the device; the
analogue of the reference's train_sample/test_sample. PyTorch keeps the
state (parameters, BatchNorm buffers, Adam moments) in the model and the
optimizer, so the steps take only a batch.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
import torch.nn as nn

from ..models.mvsnet import mvsnet_loss
from .metrics import depth_metrics

BATCH_KEYS = ("imgs", "proj_matrices", "depth_values", "depth", "mask")


def make_optimizer(model: nn.Module, lr: float, weight_decay: float = 0.0) -> torch.optim.Adam:
    """torch.optim.Adam(lr, betas (0.9, 0.999), eps 1e-8, weight_decay): the
    decay term is added to the gradient before the moment updates, as the JAX
    package's optax chain does (``train/state.py:44-55``)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def batch_to_device(batch: Mapping[str, Any], device: torch.device) -> dict[str, torch.Tensor]:
    """The batch's arrays (numpy or torch) on ``device``; u8 images are
    copied as u8 and divided by 255 there, as the JAX steps do."""
    out = {k: torch.as_tensor(batch[k]).to(device, non_blocking=True) for k in BATCH_KEYS}
    if out["imgs"].dtype == torch.uint8:
        out["imgs"] = out["imgs"].float() / 255.0
    return out


def _aux(loss: torch.Tensor, outputs: dict[str, torch.Tensor], b: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    depth = outputs["depth"].detach()
    aux = {"loss": loss.detach()}
    aux.update(depth_metrics(depth, b["depth"], b["mask"]))
    aux["depth_est"] = depth
    aux["photometric_confidence"] = outputs["photometric_confidence"].detach()
    return aux


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    device: torch.device | str,
) -> Callable[[Mapping[str, Any]], dict[str, torch.Tensor]]:
    """Return ``train_step(batch) -> aux``. batch: imgs [B, V, H, W, 3] (f32
    or u8), proj_matrices [B, V, 4, 4], depth_values [B, D], depth [B, h, w],
    mask [B, h, w]. aux: 'loss', the metric suite, 'depth_est' and
    'photometric_confidence', on the device. The step updates the model's
    parameters and BatchNorm statistics and the optimizer in place, then
    advances the scheduler; each parameter's ``.grad`` keeps the step's
    gradient."""
    device = torch.device(device)

    def train_step(batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        model.train()
        b = batch_to_device(batch, device)
        outputs = model(b["imgs"], b["proj_matrices"], b["depth_values"])
        loss = mvsnet_loss(outputs["depth"], b["depth"], b["mask"])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return _aux(loss, outputs, b)

    return train_step


def make_eval_step(
    model: nn.Module, device: torch.device | str
) -> Callable[[Mapping[str, Any]], dict[str, torch.Tensor]]:
    """Return ``eval_step(batch) -> aux``: the forward in eval mode (running
    BatchNorm statistics, no gradient), the loss and the metric suite."""
    device = torch.device(device)

    @torch.no_grad()
    def eval_step(batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        model.eval()
        b = batch_to_device(batch, device)
        outputs = model(b["imgs"], b["proj_matrices"], b["depth_values"])
        return _aux(mvsnet_loss(outputs["depth"], b["depth"], b["mask"]), outputs, b)

    return eval_step
