"""Wrapper of the single-view plane-sweep warp kernel (K5, CUDA C++).

Replaces the TPU kernel ``scene_3dreconstruction_mvsnet_tpu/ops/pallas/
plane_sweep_warp.py::warp_src_feature_pallas``: one source view's features
warped onto every depth plane of the reference view, [H, W, C] ->
[D, H, W, C] in the feature dtype, sampled in f32. The kernel
(``csrc/plane_sweep_warp.cu``) takes the sweep-variance kernel's layout: a
thread per (pixel, 8 channels) walks a chunk of planes (``launch_geometry``)
with its ray in registers, and at C = 32 the 4 lanes of a pixel split each
step of 4 planes' coordinates. It samples with the device code the
sweep-variance kernel emits its warps with (``csrc/sweep_coords.cuh``), so
the two agree bit for bit. The TPU kernel's window plan and validity flag
answer Mosaic's 128-lane gather; this kernel returns the volume only. It has
no backward: the warp under autograd is ``ops/sampling.py::
warp_src_feature_grad``'s business.

A CPU tensor takes the plain version (``ops/sampling.py::
warp_src_feature``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..sampling import warp_src_feature
from . import check_cuda_tensor, load_cuda_library
from .sweep_variance import SM_COUNT, THREADS, homography_terms, plane_chunk

LAUNCHES = 0  # kernel launches since the last reset; only the launch site adds to it

_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_cuda_library("plane_sweep_warp")
    lib.plane_sweep_warp_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.plane_sweep_warp_launch.restype = ctypes.c_int
    lib.plane_sweep_warp_error_string.argtypes = [ctypes.c_int]
    lib.plane_sweep_warp_error_string.restype = ctypes.c_char_p
    return lib


def launch_geometry(D: int, H: int, W: int, C: int, sm_count: int = SM_COUNT) -> dict:
    """K5's launch for one source view: ``grid`` (blocks of ``threads``
    (pixel, channel group) threads, times chunks of ``d_chunk`` planes, K1's
    ``plane_chunk``). The kernel itself takes the build whose lanes share the
    coordinates at C = 32, and indexes a plane's H * W * C elements in 32
    bits."""
    if H * W * C >= 2**31:
        raise ValueError(f"a plane of {H}x{W}x{C} has 2^31 elements or more")
    pixel_blocks = math.ceil(H * W * (C // 8) / THREADS)
    chunk = plane_chunk(pixel_blocks, D, sm_count)
    return {"threads": THREADS, "d_chunk": chunk, "grid": (pixel_blocks, math.ceil(D / chunk))}


def plane_sweep_warp_cuda(
    src: torch.Tensor, src_proj: torch.Tensor, ref_proj: torch.Tensor, depth_values: torch.Tensor
) -> torch.Tensor:
    """Launch K5 for one sample: src [H, W, C] (f32 or bf16, C % 8 == 0),
    src_proj and ref_proj [4, 4] f32, depth_values [D] f32 -> the warped
    volume [D, H, W, C] in the source dtype."""
    global LAUNCHES
    device = src.device
    if device.type != "cuda":
        raise ValueError(f"plane_sweep_warp_cuda takes CUDA tensors, got {device}")
    check_cuda_tensor(src, "src", _DTYPES, 3, device)
    H, W, C = src.shape
    if C % 8:
        raise ValueError(f"channels must be a multiple of 8, got {C}")
    for name, p in (("src_proj", src_proj), ("ref_proj", ref_proj)):
        if tuple(p.shape) != (4, 4) or p.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [4, 4], got {p.dtype} {tuple(p.shape)}")
    check_cuda_tensor(depth_values, "depth_values", (torch.float32,), 1, device, align=4)
    D = depth_values.shape[0]
    geom = launch_geometry(D, H, W, C, torch.cuda.get_device_properties(device).multi_processor_count)
    # the relative projection exactly as the sweep kernel's wrapper takes it
    homography = homography_terms(torch.stack([ref_proj, src_proj]).to(device))
    out = torch.empty((D, H, W, C), dtype=src.dtype, device=device)
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.plane_sweep_warp_launch(
            src.data_ptr(), int(src.dtype == torch.bfloat16), homography.data_ptr(), depth_values.data_ptr(),
            out.data_ptr(), D, H, W, C, geom["d_chunk"], stream,
        )
    if err != 0:
        raise RuntimeError(f"plane_sweep_warp kernel launch failed: {lib.plane_sweep_warp_error_string(err).decode()}")
    LAUNCHES += 1
    return out


def plane_sweep_warp(
    src_fea: torch.Tensor, src_proj: torch.Tensor, ref_proj: torch.Tensor, depth_values: torch.Tensor
) -> torch.Tensor:
    """Homography warp of source features over the depth planes:
    src_fea [B, H, W, C], src_proj and ref_proj [B, 4, 4] f32, depth_values
    [B, D] f32 -> [B, D, H, W, C] in the feature dtype, zeros where a plane
    projects outside the source image. CPU tensors take the plain version;
    CUDA tensors launch K5 once per sample."""
    if src_fea.device.type == "cpu":
        return warp_src_feature(src_fea, src_proj, ref_proj, depth_values)
    src_fea = src_fea.contiguous()
    outs = [
        plane_sweep_warp_cuda(src_fea[b], src_proj[b].float(), ref_proj[b].float(), depth_values[b].float().contiguous())
        for b in range(src_fea.shape[0])
    ]
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)
