"""Headless stage dumps of the MVSNet forward (``--debug_MVSnet``).

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/utils/debug_dump.py``: the
reference shows cv2 windows per bit; here each bit writes normalised PNGs
under ``<outdir>/debug/``. Bits, as the reference's:

  0 input images and every 4th feature channel of each view,
  1 each source view's features warped onto every D/4-th depth plane (every
    8th channel), through the single-view warp kernel K5,
  2 regularised cost slices, 3 probability slices, 4 the depth expectation,
  5 the photometric confidence and its thresholded masks.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io.images import save_image_u8
from ..ops.kernels.plane_sweep_warp import plane_sweep_warp
from ..ops.kernels.sweep_variance import sweep_variance
from ..ops.regression import depth_regression, photometric_confidence
from .misc import get_powers


def _save(outdir: str, name: str, img) -> None:
    x = np.asarray(img, dtype=np.float32)
    lo, hi = np.min(x), np.max(x)
    os.makedirs(outdir, exist_ok=True)
    save_image_u8(os.path.join(outdir, name), (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def debug_forward(model, imgs, proj_matrices, depth_values, bitmask: int, outdir: str) -> None:
    """Run the eval forward of ``model`` (an MVSNet, on its device) stage by
    stage on one batch and dump the stages ``bitmask`` selects, for the
    batch's first sample: imgs [B, V, H, W, 3] in [0, 1] (u8 images are
    divided by 255, as the steps do), proj_matrices [B, V, 4, 4],
    depth_values [B, D] (arrays or tensors).

    BatchNorm uses its running statistics, as the JAX dump applies the model
    with ``train=False``: a model in training mode (the Trainer's) is put in
    eval mode for the dump and back after it, so the dump changes no
    buffer."""
    bits = set(get_powers(bitmask))
    if not bits:
        return
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            _dump(model, imgs, proj_matrices, depth_values, bits, os.path.join(outdir, "debug"))
    finally:
        model.train(was_training)


def _dump(model, imgs, proj_matrices, depth_values, bits: set[str], dump_dir: str) -> None:
    device = next(model.parameters()).device
    dtype = model.dtype or torch.float32
    imgs = torch.as_tensor(imgs).to(device)
    imgs = imgs.float() / 255.0 if imgs.dtype == torch.uint8 else imgs.float()
    proj_matrices = torch.as_tensor(proj_matrices, dtype=torch.float32).to(device)
    depth_values = torch.as_tensor(depth_values, dtype=torch.float32).to(device)
    B, V, H, W, C = imgs.shape
    feats = model.feature(imgs.reshape(B * V, H, W, C).to(dtype)).reshape(B, V, H // 4, W // 4, -1)

    if "0" in bits:
        for v in range(V):
            _save(dump_dir, f"img_view{v}.png", _np(imgs[0, v]))
            fea = _np(feats[0, v])
            for ch in range(0, fea.shape[-1], 4):
                _save(dump_dir, f"feat_view{v}_ch{ch}.png", fea[..., ch])

    if "1" in bits:
        for v in range(1, V):
            w = _np(plane_sweep_warp(feats[:1, v], proj_matrices[:1, v], proj_matrices[:1, 0], depth_values[:1])[0])
            D = w.shape[0]
            for d in range(0, D, max(D // 4, 1)):
                for ch in range(0, w.shape[-1], 8):
                    _save(dump_dir, f"warped_v{v}_d{d}_ch{ch}.png", w[d, ..., ch])

    if bits & {"2", "3", "4", "5"}:
        volume = sweep_variance(feats, proj_matrices, depth_values, out_dtype=dtype)
        cost_reg = model.cost_regularization(volume)[..., 0].float()
        if "2" in bits:
            cr = _np(cost_reg[0])
            for d in range(0, cr.shape[0], max(cr.shape[0] // 8, 1)):
                _save(dump_dir, f"costreg_d{d}.png", cr[d])
        prob = torch.softmax(cost_reg, dim=1)
        if "3" in bits:
            p = _np(prob[0])
            for d in range(0, p.shape[0], max(p.shape[0] // 8, 1)):
                _save(dump_dir, f"prob_d{d}.png", p[d])
        if "4" in bits:
            _save(dump_dir, "depth_expectation.png", _np(depth_regression(prob, depth_values)[0]))
        if "5" in bits:
            conf = _np(photometric_confidence(prob)[0])
            _save(dump_dir, "photometric_confidence.png", conf)
            for pct in (0.1, 0.25, 0.5, 0.75, 0.9):
                _save(dump_dir, f"photo_conf_gt{int(pct * 100)}.png", conf * (conf > pct))

    print(f"[debug_dump] wrote stage dumps for bits {sorted(bits)} to {dump_dir}")
