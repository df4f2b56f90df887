"""Wrapper of the BatchNorm3d + ReLU kernels (CUDA C++), on NDHWC volumes.

Replaces no TPU kernel: the JAX package's BatchNorm was flax's, compiled by
XLA. PyTorch's BatchNorm kernels give a channel one block, so at
CostRegNet's 8 to 64 channels they leave most of the card idle through the
network's largest passes. The kernels (``csrc/batch_norm.cu``) are bound by
bytes and take the volume as CostRegNet holds it, [N, C, D, H, W] laid out
NDHWC (``torch.channels_last_3d``): each pass is one grid over chunks of
voxels with all C channels, a voxel's channels in 16-byte packs where C
allows (``tile_plan``); a transform gives each chunk a block, a reduction
about as many blocks as the card holds at once (``reduce_blocks``), each
summing a strided set of chunks. f32 in registers and no float atomics, so a
launch repeats its bits on one card. Three passes, each counted under its
own name (``launch_counts``):

- ``batch_norm_eval``: one launch, y = relu(x * scale + shift), scale and
  shift from the running statistics (``conv0_fused.py::fold_bn``'s formula);
- ``batch_norm_train``: three launches: each reduction block's per-channel
  (mean, M2) in one pass over the values shifted by its first voxel, the
  per-channel Chan combine (mean, invstd, scale, shift; the running mean and
  the running variance with the biased batch variance, flax's rule, and
  ``num_batches_tracked``, all left alone while ``recomputing``), the
  transform;
- ``batch_norm_backward``: three launches: each reduction block's per-channel
  sums of g and g * xhat (g = dy where the ReLU passed, recomputed from the
  saved x), the per-channel dgamma and dbeta, dx.

The ReLU that follows the BatchNorm is part of the kernel (``relu``); a
block without one (Hourglass3d's) runs the same kernels with it off.

A CPU tensor takes the plain version, ``F.batch_norm`` with flax's running
variance then ``F.relu`` (the arithmetic the CPU tests hold against the JAX
package), in whatever layout it comes; a CUDA tensor launches the kernels,
or raises where x is not NDHWC (``models/blocks.py::to_ndhwc`` converts).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import check_cuda_tensor, launch, load_cuda_library

TILE = 4096  # values of a chunk where a voxel's packs fill their lanes
THREADS = 256  # a block's threads, TILE // THREADS values each a chunk
BLOCKS_PER_SM = 8  # a reduction's blocks of THREADS that one SM holds at once
FINAL_THREADS = 1024  # a per-channel combine's threads, one block a channel
_DTYPES = (torch.float32, torch.bfloat16)
NDHWC = torch.channels_last_3d


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_cuda_library("batch_norm")
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.batch_norm_eval_launch.argtypes = [p, p, i, i, i, i, i, i64, p, p, p, p, f, p, p]
    lib.batch_norm_train_launch.argtypes = [p, p, i, i, i, i, i, i64, i, p, p, p, p, p, p, f, f, i, p, p]
    lib.batch_norm_backward_launch.argtypes = [p, p, p, i, i, i, i, i, i, i64, i, p, p, p, p, p, p]
    if lib.batch_norm_tile() != TILE:
        raise RuntimeError(f"batch_norm.cu tiles by {lib.batch_norm_tile()} values, the wrapper by {TILE}")
    return lib


def tile_plan(C: int, itemsize: int, aligned: bool) -> tuple[int, int, int]:
    """(channels a load, lanes a voxel, voxels a chunk) of the kernels on an
    NDHWC volume of C channels: 16 bytes a load where a voxel's C values are
    a multiple of 16 bytes and every volume is 16-byte aligned
    (``aligned``), else one value; a voxel's packs on a power of two of a
    block's lanes (the rest idle), at most THREADS; each thread TILE //
    THREADS values of a chunk."""
    vec = 16 // itemsize if aligned and C * itemsize % 16 == 0 else 1
    lanes = 1 << (C // vec - 1).bit_length()
    if lanes > THREADS:
        raise ValueError(f"the BatchNorm kernels take at most {THREADS} packs a voxel, got {C} channels")
    return vec, lanes, TILE // (vec * lanes)


def reduce_blocks(chunks: int, sm_count: int) -> int:
    """The reductions' grid over a volume of ``chunks`` chunks: as many
    blocks as ``sm_count`` SMs hold at once, or one a chunk where there are
    fewer; block b takes chunks b, b + blocks, ... and writes one scratch
    entry a channel."""
    return min(chunks, sm_count * BLOCKS_PER_SM)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _layout(*volumes: torch.Tensor) -> tuple[int, int, int, int, int]:
    """(C, voxels, 16-byte loads or not, lanes a voxel, a reduction's blocks)
    of the NDHWC volumes, all of one shape on one card."""
    C = volumes[0].shape[1]
    V = volumes[0].numel() // C
    vec, lanes, chunk = tile_plan(C, volumes[0].element_size(), all(v.data_ptr() % 16 == 0 for v in volumes))
    return C, V, int(vec > 1), lanes, reduce_blocks(-(-V // chunk), _sm_count(volumes[0].device))


def _forward(x: torch.Tensor, bn, relu: bool, keep_coef: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """y (NDHWC), and the per-channel f32 coefficients [4, C] (mean, invstd,
    scale, shift) the backward reads: the batch's in training, the running
    statistics' in eval (None there unless ``keep_coef``)."""
    y = torch.empty_like(x, memory_format=NDHWC)
    C, V, vec, lanes, blocks = _layout(x, y)
    bf16 = int(x.dtype == torch.bfloat16)
    lib = _library()
    if not bn.training:
        coef = torch.empty((4, C), dtype=torch.float32, device=x.device) if keep_coef else None
        launch(lib.batch_norm_eval_launch, x.data_ptr(), y.data_ptr(), bf16, vec, int(relu), C, lanes, V,
               bn.running_mean.data_ptr(), bn.running_var.data_ptr(), bn.weight.data_ptr(), bn.bias.data_ptr(),
               bn.eps, None if coef is None else coef.data_ptr(), device=x.device, name="batch_norm_eval")
        return y, coef
    if V < 2:
        raise ValueError(f"BatchNorm in training needs more than 1 value per channel, got {tuple(x.shape)}")
    coef = torch.empty((4, C), dtype=torch.float32, device=x.device)
    part = torch.empty((C, blocks, 2), dtype=torch.float64, device=x.device)  # each block's mean and M2
    launch(lib.batch_norm_train_launch, x.data_ptr(), y.data_ptr(), bf16, vec, int(relu), C, lanes, V, blocks,
           part.data_ptr(), bn.weight.data_ptr(), bn.bias.data_ptr(), bn.running_mean.data_ptr(),
           bn.running_var.data_ptr(), bn.num_batches_tracked.data_ptr(), bn.momentum, bn.eps, int(not bn.recomputing),
           coef.data_ptr(), device=x.device, name="batch_norm_train", launches=3)
    return y, coef


def _backward(x: torch.Tensor, dy: torch.Tensor, coef: torch.Tensor, relu: bool,
              train: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dweight, dbias) from the saved x, the forward's coefficients and
    the cotangent dy (NDHWC, x's shape and dtype); dx NDHWC."""
    dx = torch.empty_like(x, memory_format=NDHWC)
    C, V, vec, lanes, blocks = _layout(x, dy, dx)
    part = torch.empty((C, blocks, 2), dtype=torch.float32, device=x.device)
    dparams = torch.empty((4, C), dtype=torch.float32, device=x.device)  # dweight, dbias, then the dx kernel's sums
    launch(_library().batch_norm_backward_launch, x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
           int(x.dtype == torch.bfloat16), vec, int(relu), int(train), C, lanes, V, blocks, coef.data_ptr(),
           part.data_ptr(),
           dparams[0].data_ptr(), dparams[1].data_ptr(), dparams[2].data_ptr(), device=x.device,
           name="batch_norm_backward", launches=3)
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
        # NDHWC on the port's paths (the convs' input gradients, the skips'); another layout is copied
        dx, dweight, dbias = _backward(x, dy.contiguous(memory_format=NDHWC), coef, ctx.relu, ctx.train)
        return dx, dweight, dbias, None, None


def batch_norm_relu_cuda(bn, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """Launch the kernels: x [N, C, D, H, W] NDHWC, bf16 or f32, on the card,
    ``bn``'s parameters and running statistics f32 [C] there -> y NDHWC.
    Differentiable in x and ``bn``'s weight and bias."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"batch_norm_relu_cuda takes CUDA tensors, got {device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of {_DTYPES}")
    if x.dim() != 5 or not x.is_contiguous(memory_format=NDHWC):
        raise ValueError(f"x must be an NDHWC (channels_last_3d) [N, C, D, H, W] tensor, got {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    C = x.shape[1]
    for name in ("weight", "bias", "running_mean", "running_var"):
        t = getattr(bn, name)
        if t is None:
            raise ValueError(f"the BatchNorm kernels need an affine BatchNorm with running statistics ({name})")
        check_cuda_tensor(t, name, (torch.float32,), 1, device, align=4)
        if t.shape[0] != C:
            raise ValueError(f"{name} has {t.shape[0]} channels, x {C}")
    check_cuda_tensor(bn.num_batches_tracked, "num_batches_tracked", (torch.int64,), 0, device, align=8)
    if torch.is_grad_enabled() and (x.requires_grad or bn.weight.requires_grad or bn.bias.requires_grad):
        return _BatchNormReLU.apply(x, bn.weight, bn.bias, bn, relu)
    return _forward(x, bn, relu, keep_coef=False)[0]


def batch_norm_relu(bn, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """``bn`` on x [N, C, D, H, W], then ReLU if ``relu``: the plain version
    for CPU tensors, the kernels for CUDA tensors (x NDHWC)."""
    if x.device.type == "cpu":
        return batch_norm_relu_plain(bn, x, relu)
    return batch_norm_relu_cuda(bn, x, relu)
