"""Scalar and image summaries of training.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/train/logging.py::
SummaryLogger`` (the reference's save_scalars/save_images): every record goes
to ``<logdir>/scalars.jsonl`` as one JSON object (``mode``, ``step``,
``time`` and the values), and, where ``tensorboardX`` imports, to TensorBoard
as scalars under ``{mode}/{key}`` and images normalised per image. The
import is optional, as in the JAX package. Values arrive as host numbers and
numpy arrays: the Trainer moves tensors to the host at the summary cadence
only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np


class SummaryLogger:
    def __init__(self, logdir: str) -> None:
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except Exception:
            self._tb = None

    def save_scalars(self, mode: str, scalars: dict[str, float], step: int) -> None:
        rec = {"mode": mode, "step": int(step), "time": time.time()}
        for key, value in scalars.items():
            rec[key] = float(value)
            if self._tb:
                self._tb.add_scalar(f"{mode}/{key}", float(value), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def save_images(self, mode: str, images: dict[str, Any], step: int) -> None:
        """Each image ([H, W] or [H, W, 3]) normalised to [0, 1] on its own."""
        if self._tb is None:
            return
        for key, value in images.items():
            img = np.asarray(value, dtype=np.float32)
            img = img[..., None] if img.ndim == 2 else img
            lo, hi = img.min(), img.max()
            self._tb.add_image(f"{mode}/{key}", (img - lo) / (hi - lo) if hi > lo else img, step,
                               dataformats="HWC")
        self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb:
            self._tb.close()
