"""Wrapper of the plane-sweep variance kernel (K1, CUDA C++).

Replaces the TPU kernel ``scene_3dreconstruction_mvsnet_tpu/ops/pallas/
sweep_variance.py::sweep_variance_pallas``. The kernel
(``csrc/sweep_variance.cu``) computes the whole multi-view variance cost
volume in one launch per sample, with the warped per-view volumes kept in
registers; with ``emit_warps`` (the training forward) the same launch also
stores each source view's warped volume. Its bound on the H100 is the
output write and the bilinear gather through L2 (the source features fit in
the 50 MB L2); one thread per
(plane, pixel, 8 channels) keeps both loads and stores contiguous across a
warp. The TPU kernel's window planner, validity flag with XLA fallback,
column-pair packing and row-skip existed because the TPU's gather only
reaches within 128 lanes; a GPU thread loads from any address, so none of
them is ported.

A CPU tensor takes the plain version (``ops/plane_sweep.py``); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...geometry.transforms import relative_projection
from ..plane_sweep import cost_volume_variance
from . import check_cuda_tensor, load_cuda_library

LAUNCHES = 0  # kernel launches since the last reset; only the launch site adds to it
EMIT_LAUNCHES = 0  # of those, the launches that also emitted the warped volumes

_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_cuda_library("sweep_variance")
    lib.sweep_variance_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.sweep_variance_launch.restype = ctypes.c_int
    lib.sweep_variance_error_string.argtypes = [ctypes.c_int]
    lib.sweep_variance_error_string.restype = ctypes.c_char_p
    return lib


def homography_terms(proj_matrices: torch.Tensor) -> torch.Tensor:
    """[V, 4, 4] K@E (view 0 = reference) -> [V-1, 12] f32: each source
    view's R (row-major) and t of src_proj @ inv(ref_proj), computed per view
    exactly as the plain path computes them."""
    ref = proj_matrices[0:1]
    rows = []
    for v in range(1, proj_matrices.shape[0]):
        rot, trans = relative_projection(proj_matrices[v : v + 1], ref)
        rows.append(torch.cat([rot.reshape(9), trans.reshape(3)]))
    return torch.stack(rows).float().contiguous()


def sweep_variance_cuda(
    features: torch.Tensor,
    proj_matrices: torch.Tensor,
    depth_values: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    emit_warps: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 for one sample: features [V, H, W, C] (f32 or bf16, C % 8
    == 0), proj_matrices [V, 4, 4] f32, depth_values [D] f32 ->
    variance [D, H, W, C] in ``out_dtype`` (default: the features dtype);
    with ``emit_warps`` also each source view's warped volume
    [V-1, D, H, W, C] in ``out_dtype``, from the same launch."""
    global LAUNCHES, EMIT_LAUNCHES
    device = features.device
    if device.type != "cuda":
        raise ValueError(f"sweep_variance_cuda takes CUDA tensors, got {device}")
    out_dtype = out_dtype or features.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype {out_dtype} not in {_DTYPES}")
    check_cuda_tensor(features, "features", _DTYPES, 4, device)
    V, H, W, C = features.shape
    if C % 8:
        raise ValueError(f"channels must be a multiple of 8, got {C}")
    if tuple(proj_matrices.shape) != (V, 4, 4) or proj_matrices.dtype != torch.float32:
        raise ValueError(f"proj_matrices must be f32 [{V}, 4, 4], got {proj_matrices.dtype} {tuple(proj_matrices.shape)}")
    check_cuda_tensor(depth_values, "depth_values", (torch.float32,), 1, device, align=4)
    D = depth_values.shape[0]
    homography = homography_terms(proj_matrices.to(device))
    out = torch.empty((D, H, W, C), dtype=out_dtype, device=device)
    warps = torch.empty((V - 1, D, H, W, C), dtype=out_dtype, device=device) if emit_warps else None
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.sweep_variance_launch(
            features.data_ptr(), int(features.dtype == torch.bfloat16), homography.data_ptr(),
            depth_values.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
            None if warps is None else warps.data_ptr(), V, D, H, W, C, stream,
        )
    if err != 0:
        raise RuntimeError(f"sweep_variance kernel launch failed: {lib.sweep_variance_error_string(err).decode()}")
    LAUNCHES += 1
    if warps is None:
        return out
    EMIT_LAUNCHES += 1
    return out, warps


def sweep_variance(
    features: torch.Tensor,
    proj_matrices: torch.Tensor,
    depth_values: torch.Tensor,
    depth_chunk: int | None = None,
    out_dtype: torch.dtype | None = None,
    emit_warps: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Variance cost volume: features [B, V, H, W, C], proj_matrices
    [B, V, 4, 4] f32, depth_values [B, D] f32 -> [B, D, H, W, C] in
    ``out_dtype`` (default: the features dtype); accumulation is f32. With
    ``emit_warps`` also the source views' warped volumes
    [B, V-1, D, H, W, C] in ``out_dtype``.

    CPU tensors take the plain path (``depth_chunk`` bounds its memory); CUDA
    tensors launch K1 once per sample, which never holds a warped volume it
    does not emit, so ``depth_chunk`` does not apply there.
    """
    if features.device.type == "cpu":
        return cost_volume_variance(
            features, proj_matrices, depth_values, depth_chunk=depth_chunk, out_dtype=out_dtype,
            emit_warps=emit_warps,
        )
    outs = [
        sweep_variance_cuda(features[b], proj_matrices[b], depth_values[b], out_dtype, emit_warps)
        for b in range(features.shape[0])
    ]
    if not emit_warps:
        return _stack(outs)
    return _stack([o[0] for o in outs]), _stack([o[1] for o in outs])


def _stack(ts: list[torch.Tensor]) -> torch.Tensor:
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)
