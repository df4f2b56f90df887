"""Precision settings of the reference and of its controls.

The reference runs in float32 with TF32 off for matmuls and convolutions
(``exact``). A control is the reference with a ``rounding`` of the tensors
that a lower-precision path would hold in that type (every conv's input and
weight, the cost volume, the logits), gradients passed straight through:

- ``tf32``: float32 rounded to TF32's 10 mantissa bits (the control of an
  f32 configuration that states TF32 off);
- ``bf16``: bfloat16 (the control of an f32 configuration that lets cuDNN
  run its convolutions in TF32, PyTorch's default);
- ``fp8``: float8 e4m3 with a per-tensor scale to its largest value (the
  control of a bfloat16 configuration).
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


@contextlib.contextmanager
def exact():
    """float32 matmuls and convolutions without TF32, restored after."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)  # round to nearest, 10 mantissa bits kept


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


ROUND = {"tf32": _tf32, "bf16": _bf16, "fp8": _fp8}


def rounding(name: str | None):
    """The rounding of control ``name`` (None, or "f32": no rounding), with
    the gradient passed through unchanged."""
    if name in (None, "f32"):
        return None
    fn = ROUND[name]

    def straight_through(x: torch.Tensor) -> torch.Tensor:
        return x + (fn(x) - x).detach()

    return straight_through
