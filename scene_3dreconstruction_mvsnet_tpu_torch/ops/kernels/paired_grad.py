"""Wrapper of the paired sweep's backward-terms kernel (K3-terms, CUDA C++).

The variance cost volume's VJP with respect to each view's warped values is
an elementwise volume: with g the volume's cotangent and V views,

    t_v  = (2/V) g (w_v - mean)           for each source view v
    dref = sum_d (2/V) g (ref - mean)     the reference view's gradient

The JAX package lets XLA fuse it (``scene_3dreconstruction_mvsnet_tpu/ops/
paired_sweep.py``, bwd); here one launch of ``csrc/paired_grad.cu`` computes
it for the whole batch, reading g, the emitted warps and the reference
features once and writing t (f32, the warp-backward kernel's input) and dref
once. Memory bounds it. It rounds every step as the plain version does, so t
equals the plain version's bit for bit when the view sum has two terms
(V = 3); dref sums over the planes in another order, without atomics, and is
the same from run to run.

A CPU tensor takes the plain version (``paired_grad_plain``); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import check_cuda_tensor, load_cuda_library

LAUNCHES = 0  # kernel launches since the last reset; only the launch site adds to it

_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_cuda_library("paired_grad")
    lib.paired_grad_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.paired_grad_launch.restype = ctypes.c_int
    lib.paired_grad_error_string.argtypes = [ctypes.c_int]
    lib.paired_grad_error_string.restype = ctypes.c_char_p
    return lib


def paired_grad_plain(
    g_vol: torch.Tensor, warps: torch.Tensor, features: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The terms in plain PyTorch, one sample at a time (which bounds the f32
    temporaries): g_vol [B, D, H, W, C], warps [B, V-1, D, H, W, C] (both in
    the volume's dtype), features [B, V, H, W, C] -> (t [B, V-1, D, H, W, C]
    f32, dref [B, H, W, C] f32)."""
    B, V = features.shape[:2]
    coeff = 2.0 / V
    t = torch.empty(warps.shape, dtype=torch.float32, device=warps.device)
    dref = torch.empty((B, *features.shape[2:]), dtype=torch.float32, device=features.device)
    for b in range(B):
        ref = features[b, 0].float()
        wf = warps[b].float()  # [V-1, D, H, W, C]
        g32 = g_vol[b].float() * coeff
        mean = (ref[None] + wf.sum(0)) * (1.0 / V)
        dref[b] = (g32 * (ref[None] - mean)).sum(0)
        for v in range(V - 1):
            t[b, v] = g32 * (wf[v] - mean)
    return t, dref


def paired_grad_cuda(
    g_vol: torch.Tensor, warps: torch.Tensor, features: torch.Tensor, dref_out: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3-terms once for the batch: g_vol [B, D, H, W, C] in any
    strides, warps [B, V-1, D, H, W, C] in g_vol's dtype, features
    [B, V, H, W, C] (C % 8 == 0) -> (t [B, V-1, D, H, W, C] f32, dref). dref
    is written into ``dref_out`` ([B, H, W, C], f32 or bf16, each sample
    contiguous; the paired sweep passes its feature gradient's view 0), or
    into a new f32 tensor."""
    global LAUNCHES
    device = features.device
    if device.type != "cuda":
        raise ValueError(f"paired_grad_cuda takes CUDA tensors, got {device}")
    check_cuda_tensor(features, "features", _DTYPES, 5, device)
    B, V, H, W, C = features.shape
    if C % 8:
        raise ValueError(f"channels must be a multiple of 8, got {C}")
    if V < 2:
        raise ValueError(f"the paired sweep needs a reference and a source view, got {V} views")
    check_cuda_tensor(warps, "warps", _DTYPES, 6, device)
    D = warps.shape[2]
    if tuple(warps.shape) != (B, V - 1, D, H, W, C):
        raise ValueError(f"warps must be [{B}, {V - 1}, D, {H}, {W}, {C}], got {tuple(warps.shape)}")
    if g_vol.device != device or g_vol.dtype != warps.dtype or tuple(g_vol.shape) != (B, D, H, W, C):
        raise ValueError(f"g_vol must be {warps.dtype} [{B}, {D}, {H}, {W}, {C}] on {device}, got {g_vol.dtype} "
                         f"{tuple(g_vol.shape)} on {g_vol.device}")
    if dref_out is None:
        dref_out = torch.empty((B, H, W, C), dtype=torch.float32, device=device)
    aligned = (dref_out.data_ptr() | dref_out.stride(0) * dref_out.element_size()) % 16 == 0
    if (dref_out.device != device or dref_out.dtype not in _DTYPES or tuple(dref_out.shape) != (B, H, W, C)
            or not dref_out[0].is_contiguous() or not aligned):
        raise ValueError("dref_out must be an f32 or bf16 [B, H, W, C] tensor on the features' device, each sample "
                         "contiguous and 16-byte aligned")
    t = torch.empty(warps.shape, dtype=torch.float32, device=device)
    strides = (ctypes.c_int64 * 5)(*g_vol.stride())
    g_vec = g_vol.stride(4) == 1 and all(s % 8 == 0 for s in g_vol.stride()[:4]) and g_vol.data_ptr() % 16 == 0
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.paired_grad_launch(
            g_vol.data_ptr(), int(g_vec), strides, warps.data_ptr(), int(warps.dtype == torch.bfloat16),
            features.data_ptr(), int(features.dtype == torch.bfloat16), t.data_ptr(), dref_out.data_ptr(),
            int(dref_out.dtype == torch.bfloat16), dref_out.stride(0), B, V, D, H, W, C, 2.0 / V, 1.0 / V, stream,
        )
    if err != 0:
        raise RuntimeError(f"paired_grad kernel launch failed: {lib.paired_grad_error_string(err).decode()}")
    LAUNCHES += 1
    return t, dref_out


def paired_grad(
    g_vol: torch.Tensor, warps: torch.Tensor, features: torch.Tensor, dref_out: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The paired sweep's backward terms (t, dref) for a batch, as
    ``paired_grad_cuda`` describes; dref also goes into ``dref_out`` when it
    is given. CPU tensors take the plain version, CUDA tensors one launch of
    K3-terms."""
    if features.device.type == "cpu":
        t, dref = paired_grad_plain(g_vol, warps, features)
        if dref_out is None:
            return t, dref
        return t, dref_out.copy_(dref)
    return paired_grad_cuda(g_vol, warps, features, dref_out)
