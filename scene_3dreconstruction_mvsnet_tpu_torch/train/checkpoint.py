"""Checkpoints in the reference's own format.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/train/checkpoint.py``
with the reference's file instead of an orbax directory: every ``save_freq``
epochs ``torch.save({'epoch', 'model', 'optimizer'})`` to
``<logdir>/model_{epoch:06d}.ckpt``, the model's keys carrying
``nn.DataParallel``'s ``module.`` prefix as the reference's do, and resume
from the newest one (the reference's ``train.py:134-148,192-197``). The JAX
package reads the same file (``interop/torch_import.py::
load_torch_checkpoint``).
"""

from __future__ import annotations

import os
import re

import torch
import torch.nn as nn

_CKPT_RE = re.compile(r"^model_(\d+)\.ckpt$")
PREFIX = "module."


def checkpoint_path(logdir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(logdir), f"model_{epoch:0>6}.ckpt")


def save_checkpoint(logdir: str, epoch: int, model: nn.Module, optimizer: torch.optim.Optimizer) -> str:
    """Write the epoch's checkpoint; returns its path."""
    os.makedirs(logdir, exist_ok=True)
    path = checkpoint_path(logdir, epoch)
    state = {PREFIX + k: v for k, v in model.state_dict().items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"epoch": epoch, "model": state, "optimizer": optimizer.state_dict()}, tmp)
    os.replace(tmp, path)  # a reader never sees a partial file
    return path


def find_latest(logdir: str) -> str | None:
    """Newest ``model_*.ckpt`` in ``logdir`` (by epoch), or None."""
    if not os.path.isdir(logdir):
        return None
    found = [(int(m.group(1)), name) for name in os.listdir(logdir) if (m := _CKPT_RE.match(name))]
    return os.path.join(os.path.abspath(logdir), max(found)[1]) if found else None


def load_model(path: str, model: nn.Module) -> dict:
    """Load a checkpoint's weights into ``model`` (strict; a bare state dict
    or the reference's dict, with or without the ``module.`` prefix).
    Returns the loaded checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt["model"] if "model" in ckpt else ckpt
    model.load_state_dict({k.removeprefix(PREFIX): v for k, v in state.items()}, strict=True)
    return ckpt


def optimizer_steps(optimizer: torch.optim.Optimizer) -> int:
    """Number of steps the optimizer has taken (Adam keeps it per parameter)."""
    for s in optimizer.state.values():
        if "step" in s:
            return int(s["step"])
    return 0


def restore_checkpoint(
    path: str,
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
) -> int:
    """Restore the model, the optimizer and the scheduler's position from a
    checkpoint; returns the next epoch. The saved optimizer already holds the
    learning rate of the next step; the scheduler resumes counting from the
    optimizer's step count."""
    ckpt = load_model(path, model)
    optimizer.load_state_dict(ckpt["optimizer"])
    scheduler.last_epoch = optimizer_steps(optimizer)
    return int(ckpt["epoch"]) + 1
