"""Inference step: counterpart of
``scene_3dreconstruction_mvsnet_tpu/train/state.py::make_infer_step``."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from .utils import tracing


def make_infer_step(model: nn.Module, device: torch.device | str) -> Callable[..., dict]:
    """Move ``model`` to ``device`` in eval mode and return
    ``infer(imgs, proj_matrices, depth_values)``: the model's outputs on
    that device. ``model`` is any model called as MVSNet is, ``model(imgs
    [B, V, H, W, 3], proj_matrices [B, V, 4, 4], depth_values [B, D])``,
    that returns at least ``depth`` and ``photometric_confidence``: the
    port's ``MVSNet``, ``CasMVSNet`` (whose dict also holds each stage's
    maps) or ``RMVSNet`` (winner-take-all depth and its probability, at 1/4
    resolution as MVSNet's).

    u8 images are copied as u8 and divided by 255 on the device (exact for
    loaders that emit u8/255 images, and a quarter of the f32 copy). Each
    call is the ``infer`` span, its copies and the divide ``infer.h2d``
    (``utils/tracing.py``)."""
    device = torch.device(device)
    model = model.to(device).eval()

    @torch.inference_mode()
    def infer(imgs: torch.Tensor, proj_matrices: torch.Tensor, depth_values: torch.Tensor):
        with tracing.span("infer"):
            with tracing.span("infer.h2d"):
                imgs = imgs.to(device, non_blocking=True)
                if imgs.dtype == torch.uint8:
                    imgs = imgs.float() / 255.0
                proj_matrices, depth_values = proj_matrices.to(device), depth_values.to(device)
            return model(imgs, proj_matrices, depth_values)

    return infer
