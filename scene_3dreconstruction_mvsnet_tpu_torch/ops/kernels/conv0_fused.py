"""Wrapper of the fused conv0 kernel (K4, CUDA C++).

Replaces the TPU kernel ``scene_3dreconstruction_mvsnet_tpu/ops/pallas/
conv0_fused.py::conv0_bn_relu_fused``: CostRegNet's first 3D conv (3x3x3,
32 -> 8 channels) with eval-mode BatchNorm and ReLU in one pass. The kernel
(``csrc/conv0_fused.cu``) reads the channels-last bf16 cost volume
[B, D, H, W, 32] the sweep-variance kernel writes and writes the activation
[B, 8, D, H, W] in bf16, the layout conv1 takes, so the volume is not
permuted first. It is an implicit GEMM on the tensor cores (mma.sync
m16n8k16, bf16 products, f32 sums): a block owns an 8 x 32 (y, x) output
tile and streams a chunk of depth planes through shared memory
(``launch_geometry``); the weights go to it as mma B fragments
(``mma_weight_fragments``). The TPU kernel's band-Toeplitz weights and
D-streaming carries answer the MXU's tiles and are not ported.

A CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises. The plain version is an f32 ``F.conv3d`` (TF32 off) of the
bf16-rounded volume and weights, then the folded BatchNorm, ReLU and one
rounding to bf16; the kernel sums the same exact products in another order,
so the two agree to one bf16 ulp.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import check_cuda_tensor, load_cuda_library

LAUNCHES = 0  # kernel launches since the last reset; only the launch site adds to it

CI, CO = 32, 8
TILE_H, TILE_W = 8, 32  # output voxels of a block per plane, one warp per row
THREADS = TILE_H * 32
RING_SLOTS = 3  # input planes (with their one-voxel halo) in shared memory
SMEM_BYTES = (RING_SLOTS * (TILE_H + 2) * (TILE_W + 2) * CI * 2  # the ring
              + 27 * 2 * 32 * 8  # the weights as mma B fragments
              + TILE_H * CO * TILE_W * 2)  # the epilogue's transpose
BLOCKS_PER_SM = 2  # what the shared memory and the 128-register cap allow
SM_COUNT = 132  # H100 SXM
MIN_CHUNK = 4  # depth planes per block at least (each chunk rereads 2 halo planes)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_cuda_library("conv0_fused")
    lib.conv0_fused_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.conv0_fused_launch.restype = ctypes.c_int
    lib.conv0_fused_smem_bytes.restype = ctypes.c_int
    if lib.conv0_fused_smem_bytes() != SMEM_BYTES:
        raise RuntimeError(f"conv0_fused.cu uses {lib.conv0_fused_smem_bytes()} bytes of shared memory, the "
                           f"wrapper counts {SMEM_BYTES}")
    lib.conv0_fused_error_string.argtypes = [ctypes.c_int]
    lib.conv0_fused_error_string.restype = ctypes.c_char_p
    return lib


def launch_geometry(B: int, D: int, H: int, W: int, sm_count: int = SM_COUNT) -> dict:
    """K4's launch: ``grid`` = (B x tiles_y x tiles_x output tiles of
    TILE_H x TILE_W voxels, chunks of ``d_chunk`` output planes), with
    ``threads`` per block and ``smem_bytes`` of dynamic shared memory. D is
    cut into enough chunks for about 8 waves of BLOCKS_PER_SM blocks on each
    SM, each chunk at least MIN_CHUNK planes."""
    tiles_y, tiles_x = math.ceil(H / TILE_H), math.ceil(W / TILE_W)
    tiles = B * tiles_y * tiles_x
    chunks = max(1, min(math.ceil(8 * BLOCKS_PER_SM * sm_count / tiles), math.ceil(D / MIN_CHUNK)))
    d_chunk = math.ceil(D / chunks)
    return {"tiles_y": tiles_y, "tiles_x": tiles_x, "d_chunk": d_chunk, "grid": (tiles, math.ceil(D / d_chunk)),
            "threads": THREADS, "smem_bytes": SMEM_BYTES}


def mma_weight_fragments(weight: torch.Tensor) -> torch.Tensor:
    """conv weight [8, 32, 3, 3, 3] -> bf16 [27, 2, 32, 4]: for each tap
    (kd * 9 + kh * 3 + kw), half of the input channels and lane of a warp,
    the lane's B fragment of mma.sync.m16n8k16 (B = weight[ci, co] over the
    16 channels of the half): co = lane // 4, ci = 2 (lane % 4) + (0, 1, 8, 9)
    within the half."""
    wt = weight.to(torch.bfloat16).permute(2, 3, 4, 1, 0).reshape(27, CI, CO)  # [tap, ci, co]
    lane = torch.arange(32, device=weight.device)
    t = 2 * (lane % 4)
    ci = torch.stack([t, t + 1, t + 8, t + 9], dim=-1)[None] + 16 * torch.arange(2, device=weight.device)[:, None, None]
    co = (lane // 4)[None, :, None].expand(2, 32, 4)
    return wt[:, ci, co].contiguous()


def fold_bn(bn: nn.BatchNorm3d) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm as a per-channel (scale, bias) in f32:
    y = x * scale + bias with scale = gamma / sqrt(running_var + eps)."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return scale, bn.bias.float() - bn.running_mean.float() * scale


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full f32 for the duration (a reference must not
    round its inputs to TF32)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def conv0_bn_relu_plain(
    x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """x [B, D, H, W, 32], conv weight [8, 32, 3, 3, 3], folded BN scale and
    bias [8] -> relu(conv3d(x) * scale + bias) [B, 8, D, H, W] bf16, the conv
    in f32 on bf16-rounded inputs and weights."""
    xf = x.to(torch.bfloat16).float().permute(0, 4, 1, 2, 3)
    with _no_tf32():
        y = F.conv3d(xf, weight.to(torch.bfloat16).float(), padding=1)
    y = y * scale.float()[:, None, None, None] + bias.float()[:, None, None, None]
    return torch.relu(y).to(torch.bfloat16)


def conv0_bn_relu_cuda(
    x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Launch K4: x [B, D, H, W, 32] bf16 (contiguous) -> [B, 8, D, H, W]
    bf16."""
    global LAUNCHES
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"conv0_bn_relu_cuda takes CUDA tensors, got {device}")
    check_cuda_tensor(x, "x", (torch.bfloat16,), 5, device)
    B, D, H, W, C = x.shape
    if C != CI:
        raise ValueError(f"conv0 takes {CI} input channels, got {C}")
    if tuple(weight.shape) != (CO, CI, 3, 3, 3):
        raise ValueError(f"conv0 weight must be [{CO}, {CI}, 3, 3, 3], got {tuple(weight.shape)}")
    w = mma_weight_fragments(weight.detach().to(device))
    scale = scale.detach().to(device, torch.float32).contiguous()
    bias = bias.detach().to(device, torch.float32).contiguous()
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (CO,):
            raise ValueError(f"{name} must be [{CO}], got {tuple(t.shape)}")
    geom = launch_geometry(B, D, H, W, torch.cuda.get_device_properties(device).multi_processor_count)
    out = torch.empty((B, CO, D, H, W), dtype=torch.bfloat16, device=device)
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.conv0_fused_launch(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), B, D, H, W,
            geom["tiles_x"], geom["tiles_y"], geom["d_chunk"], stream,
        )
    if err != 0:
        raise RuntimeError(f"conv0_fused kernel launch failed: {lib.conv0_fused_error_string(err).decode()}")
    LAUNCHES += 1
    return out


def conv0_bn_relu(
    x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Fused eval-mode conv0 + BatchNorm + ReLU: the channels-last volume
    x [B, D, H, W, 32] -> [B, 8, D, H, W] bf16. CPU tensors take the plain
    version; CUDA tensors launch K4 (x is cast to a contiguous bf16 tensor)."""
    if x.device.type == "cpu":
        return conv0_bn_relu_plain(x, weight, scale, bias)
    return conv0_bn_relu_cuda(x.to(torch.bfloat16).contiguous(), weight, scale, bias)
