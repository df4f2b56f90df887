"""Wrapper of the fused softmax regression and photometric confidence kernel
(K2, CUDA C++).

Replaces the TPU kernel ``scene_3dreconstruction_mvsnet_tpu/ops/pallas/
softmax_regression.py::fused_softmax_regression``. Per pixel: the max over
the D planes, exp once, the sum, the expectation of the depth values and of
the plane index, depth = E[d]; confidence = the exp mass in the window
[idx-1, idx+2] over the sum, with idx = trunc(clip(E[index], 0, D-1)).

The kernel (``csrc/softmax_regression.cu``) reads the logits in the dtype
CostRegNet emits them (bf16 or f32) and converts them in registers, as the
TPU kernel converts each plane, so the bf16 eval path needs no cast kernel
before it, and bf16 logits give the same bits as the same values in f32. Its
bound on the H100 is reading the logits once; a block stages its [D x 32
pixels] tile in shared memory with ``cp.async`` and splits D into 4 slices,
so the card's SMs fill at the headline's 62,208 pixels. The TPU kernel's
unrolled D loop and exp scratch answered a TPU register limit and are not
copied.

The depth values come one per plane, ``[B, D]``, or one per plane and pixel,
``[B, D, H, W]`` (CasMVSNet's stages 2 and 3): the second takes the kernel's
per-pixel build, which differs only in the load of a plane's depth.

A CPU tensor takes the plain version (``ops/regression.py``) on the logits
cast to f32; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..regression import regress_depth_and_confidence
from . import check_cuda_tensor, load_cuda_library

LAUNCHES = 0  # kernel launches since the last reset; only the launch site adds to it
PER_PIXEL_LAUNCHES = 0  # of those, the launches with per-pixel depth values

_DTYPES = (torch.float32, torch.bfloat16)
MAX_PLANES = 1024  # a block's f32 tile of D x 32 pixels stays within 128 KB of shared memory


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_cuda_library("softmax_regression")
    lib.softmax_regression_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.softmax_regression_launch.restype = ctypes.c_int
    lib.softmax_regression_error_string.argtypes = [ctypes.c_int]
    lib.softmax_regression_error_string.restype = ctypes.c_char_p
    return lib


def softmax_regression_cuda(
    cost_reg: torch.Tensor, depth_values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2: cost_reg [B, D, H, W] logits in bf16 or f32, the pixels of
    each plane contiguous (any strides over B and D), depth_values [B, D] or
    per pixel [B, D, H, W] f32 -> (depth [B, H, W], confidence [B, H, W])
    f32."""
    global LAUNCHES, PER_PIXEL_LAUNCHES
    device = cost_reg.device
    if device.type != "cuda":
        raise ValueError(f"softmax_regression_cuda takes CUDA tensors, got {device}")
    if cost_reg.dtype not in _DTYPES:
        raise TypeError(f"cost_reg has dtype {cost_reg.dtype}, expected one of {_DTYPES}")
    if cost_reg.dim() != 4:
        raise ValueError(f"cost_reg has shape {tuple(cost_reg.shape)}, expected 4 dims")
    B, D, H, W = cost_reg.shape
    if (W > 1 and cost_reg.stride(3) != 1) or (H > 1 and cost_reg.stride(2) != W):
        raise ValueError(f"the pixels of each plane of cost_reg must be contiguous, got strides {cost_reg.stride()}")
    if not 1 <= D <= MAX_PLANES:
        raise ValueError(f"K2 takes 1 to {MAX_PLANES} planes, got {D}")
    per_pixel = depth_values.dim() == 4
    check_cuda_tensor(depth_values, "depth_values", (torch.float32,), 4 if per_pixel else 2, device, align=4)
    want = (B, D, H, W) if per_pixel else (B, D)
    if tuple(depth_values.shape) != want:
        raise ValueError(f"depth_values must be {list(want)}, got {tuple(depth_values.shape)}")
    esize = cost_reg.element_size()
    stride_b, stride_d = cost_reg.stride(0), cost_reg.stride(1)
    vec = all(n % 16 == 0 for n in (cost_reg.data_ptr(), stride_b * esize, stride_d * esize))
    depth, conf = torch.empty((2, B, H, W), dtype=torch.float32, device=device).unbind(0)
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.softmax_regression_launch(
            cost_reg.data_ptr(), int(cost_reg.dtype == torch.bfloat16), stride_b, stride_d, depth_values.data_ptr(),
            depth.data_ptr(), conf.data_ptr(), B, D, H * W, int(vec), int(per_pixel), stream,
        )
    if err != 0:
        raise RuntimeError(f"softmax_regression kernel launch failed: {lib.softmax_regression_error_string(err).decode()}")
    LAUNCHES += 1
    PER_PIXEL_LAUNCHES += per_pixel
    return depth, conf


def softmax_regression(
    cost_reg: torch.Tensor, depth_values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth and photometric confidence from the regularised cost
    [B, D, H, W] (logits in the compute dtype, regressed in f32) and depth
    values [B, D] or per pixel [B, D, H, W]: the plain path for CPU tensors,
    K2 for CUDA tensors."""
    if cost_reg.device.type == "cpu":
        return regress_depth_and_confidence(cost_reg.float(), depth_values)
    return softmax_regression_cuda(cost_reg, depth_values)
