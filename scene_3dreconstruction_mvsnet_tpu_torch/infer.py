"""Inference step: counterpart of
``scene_3dreconstruction_mvsnet_tpu/train/state.py::make_infer_step``."""

from __future__ import annotations

from typing import Callable

import torch

from .models.mvsnet import MVSNet


def make_infer_step(model: MVSNet, device: torch.device | str) -> Callable[..., dict[str, torch.Tensor]]:
    """Move ``model`` to ``device`` in eval mode and return
    ``infer(imgs, proj_matrices, depth_values) -> {'depth',
    'photometric_confidence'}`` on that device.

    u8 images are copied as u8 and divided by 255 on the device (exact for
    loaders that emit u8/255 images, and a quarter of the f32 copy)."""
    device = torch.device(device)
    model = model.to(device).eval()

    @torch.inference_mode()
    def infer(imgs: torch.Tensor, proj_matrices: torch.Tensor, depth_values: torch.Tensor):
        imgs = imgs.to(device, non_blocking=True)
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        return model(imgs, proj_matrices.to(device), depth_values.to(device))

    return infer
