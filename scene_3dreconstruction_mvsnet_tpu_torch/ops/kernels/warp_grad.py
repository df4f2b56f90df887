"""Wrapper of the warp-backward kernel (K3, CUDA C++).

Replaces the TPU kernel ``scene_3dreconstruction_mvsnet_tpu/ops/pallas/
warp_grad.py::warp_grad_pallas``: the gradient of the plane-sweep warp with
respect to one source view's features, with the sweep coordinates held
constant. The kernel (``csrc/warp_grad.cu``) scatters each cotangent sample,
times its four bilinear tap weights, into an f32 accumulator with atomics;
it recomputes the coordinates with the device code the sweep kernel samples
with (``csrc/sweep_coords.cuh``). The TPU kernel's gather form over the
inverse homography, its window planner and validity flag answer Mosaic's
128-lane gather and are not ported.

A CPU tensor takes the plain version (``ops/sampling.py::
warp_src_feature_grad``, grid_sample's own backward); a CUDA tensor launches
the kernel or raises. f32 atomics sum in an order that varies from run to
run, so the kernel agrees with its plain version to a tolerance, not bit for
bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..sampling import warp_src_feature_grad
from . import check_cuda_tensor, load_cuda_library
from .sweep_variance import homography_terms

LAUNCHES = 0  # kernel launches since the last reset; only the launch site adds to it


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_cuda_library("warp_grad")
    lib.warp_grad_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.warp_grad_launch.restype = ctypes.c_int
    lib.warp_grad_error_string.argtypes = [ctypes.c_int]
    lib.warp_grad_error_string.restype = ctypes.c_char_p
    return lib


def warp_grad_cuda(
    g: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth_values: torch.Tensor,
) -> torch.Tensor:
    """Launch K3 for one sample and one source view: the f32 cotangent
    g [D, H, W, C] (C % 8 == 0) of the warped volume, src_proj and ref_proj
    [4, 4] f32, depth_values [D] f32 -> dsrc [H, W, C] f32."""
    global LAUNCHES
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"warp_grad_cuda takes CUDA tensors, got {device}")
    check_cuda_tensor(g, "g", (torch.float32,), 4, device)
    D, H, W, C = g.shape
    if C % 8:
        raise ValueError(f"channels must be a multiple of 8, got {C}")
    for name, p in (("src_proj", src_proj), ("ref_proj", ref_proj)):
        if tuple(p.shape) != (4, 4) or p.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [4, 4], got {p.dtype} {tuple(p.shape)}")
    check_cuda_tensor(depth_values, "depth_values", (torch.float32,), 1, device, align=4)
    if depth_values.shape[0] != D:
        raise ValueError(f"depth_values must have {D} planes, got {depth_values.shape[0]}")
    # the relative projection exactly as the sweep kernel's wrapper takes it
    homography = homography_terms(torch.stack([ref_proj, src_proj]).to(device))
    dsrc = torch.zeros((H, W, C), dtype=torch.float32, device=device)
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.warp_grad_launch(
            g.data_ptr(), homography.data_ptr(), depth_values.data_ptr(), dsrc.data_ptr(),
            D, H, W, C, stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_grad kernel launch failed: {lib.warp_grad_error_string(err).decode()}")
    LAUNCHES += 1
    return dsrc


def warp_grad(
    g: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth_values: torch.Tensor,
) -> torch.Tensor:
    """Gradient of the plane-sweep warp with respect to the source features:
    cotangent g [B, D, H, W, C], src_proj and ref_proj [B, 4, 4] f32,
    depth_values [B, D] f32 -> dsrc [B, H, W, C] f32. CPU tensors take the
    plain version; CUDA tensors launch K3 once per sample (g is cast to a
    contiguous f32 tensor first)."""
    if g.device.type == "cpu":
        return warp_src_feature_grad(g, src_proj, ref_proj, depth_values)
    g = g.float().contiguous()
    return torch.stack([
        warp_grad_cuda(g[b], src_proj[b], ref_proj[b], depth_values[b].contiguous())
        for b in range(g.shape[0])
    ])
