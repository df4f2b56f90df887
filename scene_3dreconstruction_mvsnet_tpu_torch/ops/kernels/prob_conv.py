"""Wrapper of CostRegNet's ``prob`` conv kernels (CUDA C++): 3x3x3, 8 -> 1
channel, forward and backward.

Replaces no TPU kernel: the JAX package left this conv to XLA. cuDNN runs
it, with its one output channel, on an f32 engine at about 120x the card's
bound (``csrc/prob_conv.cu`` says how the kernels are built). Two names count
its launches (``launch_counts``):

- ``prob_conv``: one launch a forward;
- ``prob_conv_backward``: the input gradient (one launch) and the weight and
  bias gradient (two: each block's sums, then their sum in a fixed order), as
  many as autograd asks for.

The kernels take x [B, 8, D_in, H, W] (bf16 or f32) laid out NDHWC
(``torch.channels_last_3d``, CostRegNet's layout: a voxel's 8 channels are
16 bytes in bf16) with D padded by one zero plane at each end (``pad_d`` 1)
or, on the sweep split, carrying the neighbours' planes (``pad_d`` 0: D_in =
D + 2), sum in f32 and round each output once; the input gradient comes back
NDHWC. The output [B, 1, D, H, W] is the same tensor in either layout. A CPU
tensor takes the plain version, ``F.conv3d`` with the same padding, in
whatever layout it comes; a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ...parallel.halo import exchange_halos
from . import check_cuda_tensor, launch, load_cuda_library

TILE_COLS = 32  # output columns of every kernel's tile
TILE_ROWS = {"forward": 16, "dgrad": 4, "wgrad": 8}  # output rows of each kernel's tile
WARPS = {"forward": 8, "dgrad": 4, "wgrad": 4}  # warps of each kernel's block
MIN_CHUNK = 4  # planes of D a block walks at least (each chunk reads two planes more)
TARGET_WARPS = 4096  # warps a launch aims at: two waves of 16 on each of the card's 132 SMs
SUMS = 8 * 27 + 1  # the weight gradient's sums and the bias gradient's
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_cuda_library("prob_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.prob_conv_forward_launch.argtypes = [p, p, p, p] + [i] * 12 + [p]
    lib.prob_conv_backward_launch.argtypes = [p] * 7 + [i] * 16 + [p]
    lib.prob_conv_tile_rows.argtypes = [i]
    tiles = {k: lib.prob_conv_tile_rows(n) for n, k in enumerate(TILE_ROWS)}
    if tiles != TILE_ROWS or lib.prob_conv_tile_cols() != TILE_COLS:
        raise RuntimeError(f"prob_conv.cu tiles by {tiles} x {lib.prob_conv_tile_cols()}, the wrapper by "
                           f"{TILE_ROWS} x {TILE_COLS}")
    return lib


def launch_plan(kernel: str, B: int, D: int, H: int, W: int) -> tuple[int, int, int, int]:
    """(tiles along W, tiles along H, planes a chunk, chunks) of ``kernel``'s
    launch over B samples of D output planes of H x W: the tiles cover the
    plane, the chunks D, and the chunk is the smallest of at least MIN_CHUNK
    planes that keeps the grid within about TARGET_WARPS warps."""
    tiles_w, tiles_h = -(-W // TILE_COLS), -(-H // TILE_ROWS[kernel])
    per_plane = B * tiles_w * tiles_h
    chunk = min(D, max(MIN_CHUNK, -(-D * per_plane * WARPS[kernel] // TARGET_WARPS)))
    return tiles_w, tiles_h, chunk, -(-D // chunk)


def prob_conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, pad_d: int) -> torch.Tensor:
    """The conv as ``F.conv3d``: padding ``pad_d`` on D and 1 on H and W."""
    return F.conv3d(x, weight, bias, 1, (pad_d, 1, 1))


def _aligned(W: int | None, *volumes: torch.Tensor) -> int:
    """1 where the kernels may copy and store 16 bytes at a time: every
    volume 16-byte aligned and, where a single-channel plane is copied (``W``
    given), W a multiple of 16 bytes' values."""
    rows = W is None or W * volumes[0].element_size() % 16 == 0
    return int(rows and all(v.data_ptr() % 16 == 0 for v in volumes))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, pad_d: int) -> torch.Tensor:
    B, _, D_in, H, W = x.shape
    D_out = D_in + 2 * pad_d - 2
    y = torch.empty((B, 1, D_out, H, W), dtype=x.dtype, device=x.device)
    launch(_library().prob_conv_forward_launch, x.data_ptr(), weight.data_ptr(), _ptr(bias), y.data_ptr(),
           int(x.dtype == torch.bfloat16), _aligned(None, x), B, D_in, D_out, H, W, pad_d,
           *launch_plan("forward", B, D_out, H, W), device=x.device, name="prob_conv")
    return y


def _backward(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, pad_d: int, need_x: bool, need_w: bool,
              has_bias: bool) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """(dx, dweight, dbias) from the saved NDHWC x and weight and the
    contiguous cotangent g [B, 1, D_out, H, W]; dx (NDHWC) only with
    ``need_x``, dweight (and dbias, where the conv has a bias) only with
    ``need_w``."""
    B, _, D_in, H, W = x.shape
    D_out = g.shape[2]
    gx = torch.empty_like(x, memory_format=torch.channels_last_3d) if need_x else None
    dweight = torch.empty_like(weight) if need_w else None
    dbias = torch.empty(1, dtype=x.dtype, device=x.device) if need_w and has_bias else None
    wplan = launch_plan("wgrad", B, D_out, H, W)
    part = torch.empty(SUMS * B * math.prod(wplan[:2]) * wplan[3], dtype=torch.float32, device=x.device) \
        if need_w else None
    launch(_library().prob_conv_backward_launch, x.data_ptr(), weight.data_ptr(), g.data_ptr(), _ptr(gx),
           _ptr(part), _ptr(dweight), _ptr(dbias), int(x.dtype == torch.bfloat16),
           _aligned(W, *(t for t in (x, g, gx) if t is not None)), B, D_in, D_out, H, W, pad_d,
           *launch_plan("dgrad", B, D_in, H, W), *wplan, device=x.device, name="prob_conv_backward",
           launches=int(need_x) + 2 * int(need_w))
    return gx, dweight, dbias


class _ProbConv(torch.autograd.Function):
    """The forward kernel; the backward the dgrad and wgrad kernels, each
    gradient in the dtype of its input."""

    @staticmethod
    def forward(ctx, x, weight, bias, pad_d):
        ctx.save_for_backward(x, weight)
        ctx.pad_d, ctx.has_bias = pad_d, bias is not None
        return _forward(x, weight, bias, pad_d)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        if not (need_x or need_w or need_b):
            return None, None, None, None
        gx, dweight, dbias = _backward(x, weight, g.contiguous(), ctx.pad_d, need_x, need_w or need_b,
                                       ctx.has_bias)
        return gx, dweight if need_w else None, dbias if need_b else None, None


def prob_conv_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, pad_d: int) -> torch.Tensor:
    """Launch the kernels: x [B, 8, D_in, H, W] NDHWC, bf16 or f32, on the
    card, the weight [1, 8, 3, 3, 3] and the bias [1] (or None) in x's dtype
    there;
    ``pad_d`` 1 (zero padding on D) or 0 (D_in = D + 2). Differentiable in
    all three."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"prob_conv_cuda takes CUDA tensors, got {device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of {_DTYPES}")
    if x.dim() != 5 or x.shape[1] != 8 or not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError(f"x must be an NDHWC (channels_last_3d) [B, 8, D, H, W] tensor, got {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    if pad_d not in (0, 1) or x.shape[2] + 2 * pad_d - 2 < 1:
        raise ValueError(f"pad_d {pad_d} on {x.shape[2]} planes gives no output plane")
    check_cuda_tensor(weight, "weight", (x.dtype,), 5, device, align=1)
    if tuple(weight.shape) != (1, 8, 3, 3, 3):
        raise ValueError(f"weight has shape {tuple(weight.shape)}, expected [1, 8, 3, 3, 3]")
    if bias is not None:
        check_cuda_tensor(bias, "bias", (x.dtype,), 1, device, align=1)
        if bias.shape[0] != 1:
            raise ValueError(f"bias has shape {tuple(bias.shape)}, expected [1]")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weight, bias)):
        return _ProbConv.apply(x, weight, bias, pad_d)
    return _forward(x, weight, bias, pad_d)


def prob_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, sweep=None) -> torch.Tensor:
    """CostRegNet's ``prob`` on x [B, 8, D, H, W] (NDHWC on the card) in the
    compute dtype, its parameters cast to it -> [B, 1, D, H, W]; with ``sweep``
    (``parallel.VolumeSharding``), D is this rank's slice and is padded with
    the neighbours' planes (``parallel/halo.py``). The plain version for CPU
    tensors, the kernels for CUDA tensors."""
    pad_d = 1
    if sweep is not None:
        x, pad_d = exchange_halos(x, 2, 1, 1, sweep.group), 0
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if x.device.type == "cpu":
        return prob_conv_plain(x, weight, bias, pad_d)
    return prob_conv_cuda(x, weight, bias, pad_d)
