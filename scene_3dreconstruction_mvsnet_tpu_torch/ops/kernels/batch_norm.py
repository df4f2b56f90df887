"""Wrapper of the BatchNorm3d + ReLU kernels (CUDA C++).

Replaces no TPU kernel: the JAX package's BatchNorm was flax's, compiled by
XLA. PyTorch's NCDHW BatchNorm kernels give one block to each channel, so at
CostRegNet's 8 to 64 channels they leave most of the card idle through the
network's largest passes. The kernels (``csrc/batch_norm.cu``) are bound by
bytes; each pass is one grid over (spatial tile, channel, sample) of the
contiguous volume, TILE values a block, 16-byte loads and stores where the
rows allow, f32 in registers and no float atomics, so a launch repeats its
bits. Three passes, each counted under its own name (``launch_counts``):

- ``batch_norm_eval``: one launch, y = relu(x * scale + shift), scale and
  shift from the running statistics (``conv0_fused.py::fold_bn``'s formula);
- ``batch_norm_train``: three launches: each tile's (mean, M2), the
  per-channel Chan combine (mean, invstd, scale, shift; the running mean and
  the running variance with the biased batch variance, flax's rule, and
  ``num_batches_tracked``, all left alone while ``recomputing``), the
  transform;
- ``batch_norm_backward``: three launches: each tile's sums of g and
  g * xhat (g = dy where the ReLU passed, recomputed from the saved x), the
  per-channel dgamma and dbeta, dx.

The ReLU that follows the BatchNorm is part of the kernel (``relu``); a
block without one (Hourglass3d's) runs the same kernels with it off.

A CPU tensor takes the plain version, ``F.batch_norm`` with flax's running
variance then ``F.relu`` (the arithmetic the CPU tests hold against the JAX
package); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import check_cuda_tensor, load_cuda_library

EVAL_LAUNCHES = 0  # kernel launches since the last reset, by pass; only the launch sites add to them
TRAIN_LAUNCHES = 0
BACKWARD_LAUNCHES = 0

TILE = 4096  # values of one (sample, channel) row a block owns
THREADS = 256  # a block's threads, TILE // THREADS values each
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_cuda_library("batch_norm")
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.batch_norm_eval_launch.argtypes = [p, p, i, i, i, i, i, i64, p, p, p, p, f, p, p]
    lib.batch_norm_train_launch.argtypes = [p, p, i, i, i, i, i, i64, p, p, p, p, p, p, f, f, i, p, p]
    lib.batch_norm_backward_launch.argtypes = [p, p, p, i, i, i, i, i, i, i64, p, p, p, p, p, p]
    for fn in (lib.batch_norm_eval_launch, lib.batch_norm_train_launch, lib.batch_norm_backward_launch,
               lib.batch_norm_tile):
        fn.restype = ctypes.c_int
    if lib.batch_norm_tile() != TILE:
        raise RuntimeError(f"batch_norm.cu tiles rows by {lib.batch_norm_tile()} values, the wrapper by {TILE}")
    lib.batch_norm_error_string.argtypes = [ctypes.c_int]
    lib.batch_norm_error_string.restype = ctypes.c_char_p
    return lib


def tile_plan(S: int, itemsize: int, aligned: bool) -> tuple[int, int]:
    """(tiles of a row of S values, values a load) for the kernels: 16 bytes
    a load where every row starts 16-byte aligned (``aligned``: the
    volumes' addresses are; and S * itemsize a multiple of 16), else 1."""
    vec = 16 // itemsize if aligned and S * itemsize % 16 == 0 else 1
    return -(-S // TILE), vec


def batch_norm_relu_plain(bn, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """``bn`` (a BatchNorm module with flax's training semantics,
    ``models/blocks.py``) on x, then ReLU if ``relu``: ``F.batch_norm``.

    In training, torch normalises with the biased variance but adds
    ``momentum * var * n / (n - 1)`` to the running variance. The kernel
    updates a copy of the running variance (autograd keeps that copy, so the
    buffer may change after the call); the batch term is recovered from the
    copy's update and rescaled by ``(n - 1) / n``, flax's rule. The
    activation is read once: an explicit f32 variance of a bf16 activation
    would read it again and hold an f32 copy. While ``bn.recomputing`` no
    buffer moves."""
    if not bn.training:
        y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
    else:
        n = x.numel() // x.shape[1]
        mean = bn.running_mean.clone() if bn.recomputing else bn.running_mean
        updated = bn.running_var.clone()
        y = F.batch_norm(x, mean, updated, bn.weight, bn.bias, True, bn.momentum, bn.eps)
        if not bn.recomputing:
            bn.num_batches_tracked.add_(1)
            with torch.no_grad():
                keep = (1.0 - bn.momentum) * bn.running_var  # flax: 0.9 * running var
                bn.running_var.copy_((updated - keep) * ((n - 1) / n) + keep)
    return F.relu(y) if relu else y


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"batch_norm kernel launch failed: {_library().batch_norm_error_string(err).decode()}")


def _layout(*volumes: torch.Tensor) -> tuple[int, int, int, int, int]:
    """(N, C, S, tiles, 16-byte loads or not) of the contiguous volumes, all
    of one shape."""
    N, C = volumes[0].shape[:2]
    S = volumes[0].numel() // (N * C)
    tiles, vec = tile_plan(S, volumes[0].element_size(), all(v.data_ptr() % 16 == 0 for v in volumes))
    return N, C, S, tiles, int(vec > 1)


def _forward(x: torch.Tensor, bn, relu: bool, keep_coef: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """y, and the per-channel f32 coefficients [4, C] (mean, invstd, scale,
    shift) the backward reads: the batch's in training, the running
    statistics' in eval (None there unless ``keep_coef``)."""
    global EVAL_LAUNCHES, TRAIN_LAUNCHES
    y = torch.empty_like(x)
    N, C, S, tiles, vec = _layout(x, y)
    bf16 = int(x.dtype == torch.bfloat16)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if not bn.training:
            coef = torch.empty((4, C), dtype=torch.float32, device=x.device) if keep_coef else None
            _launch(lib.batch_norm_eval_launch, x.data_ptr(), y.data_ptr(), bf16, vec, int(relu), N, C, S,
                    bn.running_mean.data_ptr(), bn.running_var.data_ptr(), bn.weight.data_ptr(),
                    bn.bias.data_ptr(), bn.eps, None if coef is None else coef.data_ptr(), stream)
            EVAL_LAUNCHES += 1
            return y, coef
        if N * S < 2:
            raise ValueError(f"BatchNorm in training needs more than 1 value per channel, got {tuple(x.shape)}")
        coef = torch.empty((4, C), dtype=torch.float32, device=x.device)
        part = torch.empty((C, N, tiles, 2), dtype=torch.float32, device=x.device)
        _launch(lib.batch_norm_train_launch, x.data_ptr(), y.data_ptr(), bf16, vec, int(relu), N, C, S,
                part.data_ptr(), bn.weight.data_ptr(), bn.bias.data_ptr(), bn.running_mean.data_ptr(),
                bn.running_var.data_ptr(), bn.num_batches_tracked.data_ptr(), bn.momentum, bn.eps,
                int(not bn.recomputing), coef.data_ptr(), stream)
    TRAIN_LAUNCHES += 3
    return y, coef


def _backward(x: torch.Tensor, dy: torch.Tensor, coef: torch.Tensor, relu: bool,
              train: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dweight, dbias) from the saved x, the forward's coefficients and
    the cotangent dy (contiguous, x's shape and dtype)."""
    global BACKWARD_LAUNCHES
    dx = torch.empty_like(x)
    N, C, S, tiles, vec = _layout(x, dy, dx)
    part = torch.empty((C, N, tiles, 2), dtype=torch.float32, device=x.device)
    dparams = torch.empty((4, C), dtype=torch.float32, device=x.device)  # dweight, dbias, then the dx kernel's sums
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        _launch(_library().batch_norm_backward_launch, x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                int(x.dtype == torch.bfloat16), vec, int(relu), int(train), N, C, S, coef.data_ptr(),
                part.data_ptr(), dparams[0].data_ptr(), dparams[1].data_ptr(), dparams[2].data_ptr(), stream)
    BACKWARD_LAUNCHES += 3
    return dx, dparams[0], dparams[1]


class _BatchNormReLU(torch.autograd.Function):
    """The kernels' forward; the backward saves x and the [4, C]
    coefficients only (the ReLU's mask is recomputed from them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn, relu):
        y, coef = _forward(x, bn, relu, keep_coef=True)
        ctx.save_for_backward(x, coef)
        ctx.relu, ctx.train = relu, bn.training
        return y

    @staticmethod
    def backward(ctx, dy):
        x, coef = ctx.saved_tensors
        dx, dweight, dbias = _backward(x, dy.contiguous(), coef, ctx.relu, ctx.train)
        return dx, dweight, dbias, None, None


def batch_norm_relu_cuda(bn, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """Launch the kernels: x [N, C, D, H, W] bf16 or f32 on the card, ``bn``'s
    parameters and running statistics f32 [C] there. Differentiable in x
    and ``bn``'s weight and bias."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"batch_norm_relu_cuda takes CUDA tensors, got {device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of {_DTYPES}")
    if x.dim() != 5:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected [N, C, D, H, W]")
    C = x.shape[1]
    for name in ("weight", "bias", "running_mean", "running_var"):
        t = getattr(bn, name)
        if t is None:
            raise ValueError(f"the BatchNorm kernels need an affine BatchNorm with running statistics ({name})")
        check_cuda_tensor(t, name, (torch.float32,), 1, device, align=4)
        if t.shape[0] != C:
            raise ValueError(f"{name} has {t.shape[0]} channels, x {C}")
    check_cuda_tensor(bn.num_batches_tracked, "num_batches_tracked", (torch.int64,), 0, device, align=8)
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or bn.weight.requires_grad or bn.bias.requires_grad):
        return _BatchNormReLU.apply(x, bn.weight, bn.bias, bn, relu)
    return _forward(x, bn, relu, keep_coef=False)[0]


def batch_norm_relu(bn, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """``bn`` on x [N, C, D, H, W], then ReLU if ``relu``: the plain version
    for CPU tensors, the kernels for CUDA tensors."""
    if x.device.type == "cpu":
        return batch_norm_relu_plain(bn, x, relu)
    return batch_norm_relu_cuda(bn, x, relu)
