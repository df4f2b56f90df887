"""Wrapper of the warp-backward kernel (K3, CUDA C++).

Replaces the TPU kernel ``scene_3dreconstruction_mvsnet_tpu/ops/pallas/
warp_grad.py::warp_grad_pallas``: the gradient of the plane-sweep warp with
respect to one source view's features, with the sweep coordinates held
constant. The kernel (``csrc/warp_grad.cu``) takes the TPU kernel's gather
form: a thread per (source pixel, 8 channels) walks the planes, visits the
ref pixels in a candidate box found through the plane's inverse pixel
homography, recomputes each one's sample coordinate with the device code the
sweep kernel gathered with (``csrc/sweep_coords.cuh``) and adds the weight of
its tap on the pixel. No atomics: the result is the same bit for bit from run
to run. One launch takes every (sample, source view) pair of a train step.

The wrapper computes the boxes' geometry on the device without waiting for
it (``gather_geometry``): each plane's inverse map and a flag saying whether
the map keeps the sign of its denominators, without which the box is not
exact and the kernel walks every ref pixel of that plane. The TPU kernel's
GradPlan windows, pair-parity split, static envelopes and validity output
answer Mosaic's 128-lane gather and are not ported.

A CPU tensor takes the plain version (``ops/sampling.py::
warp_src_feature_grad``, grid_sample's own backward); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..sampling import warp_src_feature_grad
from . import check_cuda_tensor, load_cuda_library
from .sweep_variance import homography_terms

LAUNCHES = 0  # kernel launches since the last reset; only the launch site adds to it

BOX_MARGIN = 1.0  # px the candidate box is widened by on each side, against the f32 maps' rounding
DENOM_EPS = 1e-6  # a denominator closer to 0 than this (maps scaled to max |entry| 1) clears the flag

_OUT_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_cuda_library("warp_grad")
    lib.warp_grad_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.warp_grad_launch.restype = ctypes.c_int
    lib.warp_grad_error_string.argtypes = [ctypes.c_int]
    lib.warp_grad_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _pixel_frames(device: torch.device, height: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """f64 constants on ``device``: the map from the sweep's pixel coordinate
    (px, py, 1) to grid_sample's pixel units (ix = px W/(W-1) - 1/2, the same
    in y), and the homogeneous corners [3, 4] of [-1, W] x [-1, H], the region
    the flag checks (the candidate boxes' corners reach one pixel past the
    image, and so do the ref pixels around them)."""
    frame = torch.tensor([[width / (width - 1.0), 0.0, -0.5], [0.0, height / (height - 1.0), -0.5], [0.0, 0.0, 1.0]],
                         dtype=torch.float64, device=device)
    corners = torch.tensor([[x, y, 1.0] for x in (-1.0, float(width)) for y in (-1.0, float(height))],
                           dtype=torch.float64, device=device).T
    return frame, corners


def gather_geometry(
    homography: torch.Tensor, depth_values: torch.Tensor, height: int, width: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather's per-plane geometry: homography [N, 12] f32 (each pair's
    R row-major and t, as the sweep kernel takes them), depth_values [N, D]
    -> (inv_maps [N, D, 9] f32, ok [N, D] bool).

    Plane d's pixel homography G = frame (d R + t e3^T) maps ref pixel
    (x, y, 1) to the forward's source coordinate in grid_sample's pixel
    units; inv_maps holds G^-1, built in f64 and scaled to max |entry| 1. ok
    says that the denominators of both G and G^-1 keep one sign over
    [-1, W] x [-1, H], at least DENOM_EPS from 0 with each map scaled to max
    |entry| 1 (the JAX package's check, ops/pallas/warp_grad.py
    ``_support_bounds``): a projective map is then monotonic over the region,
    and the bounding box of the corners' images holds every ref pixel that
    samples a source pixel. A singular or non-finite map clears it too.
    Plain torch on the inputs' device; nothing waits for the device."""
    if height < 2 or width < 2:
        raise ValueError(f"the sweep needs at least 2 rows and 2 columns, got {height}x{width}")
    frame, corners = _pixel_frames(homography.device, height, width)
    hm = homography.double()
    planes = depth_values.double()[:, :, None, None] * hm[:, None, :9].reshape(-1, 1, 3, 3)
    fwd = frame @ (planes + torch.nn.functional.pad(hm[:, None, 9:, None], (2, 0)))  # [N, D, 3, 3]
    inv = torch.linalg.inv_ex(fwd)[0]

    def one_sign(m):  # NaN compares false and clears the flag
        den = (m[..., 2:, :] @ corners)[..., 0, :] / m.abs().amax(dim=(-2, -1))[..., None]
        return (den > DENOM_EPS).all(-1) | (den < -DENOM_EPS).all(-1)

    ok = one_sign(fwd) & one_sign(inv)
    inv_maps = (inv / inv.abs().amax(dim=(-2, -1), keepdim=True)).nan_to_num().float()
    return inv_maps.reshape(*inv.shape[:2], 9), ok


def warp_grad_cuda(
    g: torch.Tensor,
    homography: torch.Tensor,
    depth_values: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K3 once for N (sample, source view) pairs: the f32 cotangents
    g [N, D, H, W, C] (C % 8 == 0) of their warped volumes, homography
    [N, 12] f32 (``homography_terms``), depth_values [N, D] f32 -> dsrc. The
    result goes into ``out``, an f32 or bf16 [G, P, H, W, C] tensor with
    G * P = N whose [H, W, C] blocks are contiguous (pair n is out[n // P,
    n % P]; the paired sweep passes its feature gradient's source views), or
    into a new f32 [N, H, W, C] tensor, which is returned."""
    global LAUNCHES
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"warp_grad_cuda takes CUDA tensors, got {device}")
    check_cuda_tensor(g, "g", (torch.float32,), 5, device)
    N, D, H, W, C = g.shape
    if C % 8:
        raise ValueError(f"channels must be a multiple of 8, got {C}")
    check_cuda_tensor(homography, "homography", (torch.float32,), 2, device, align=4)
    check_cuda_tensor(depth_values, "depth_values", (torch.float32,), 2, device, align=4)
    if tuple(homography.shape) != (N, 12) or tuple(depth_values.shape) != (N, D):
        raise ValueError(f"homography must be [{N}, 12] and depth_values [{N}, {D}], got "
                         f"{tuple(homography.shape)} and {tuple(depth_values.shape)}")
    result = out
    if out is None:
        result = torch.empty((N, H, W, C), dtype=torch.float32, device=device)
        out = result[:, None]
    if (out.device != device or out.dtype not in _OUT_DTYPES or out.dim() != 5 or tuple(out.shape[2:]) != (H, W, C)
            or out.shape[0] * out.shape[1] != N or not out[0, 0].is_contiguous()
            or (out.data_ptr() | (out.stride(0) | out.stride(1)) * out.element_size()) % 16):
        raise ValueError(f"out must be an f32 or bf16 [G, P, {H}, {W}, {C}] tensor with G * P = {N} on {device}, "
                         "each [H, W, C] block contiguous and 16-byte aligned")
    inv_maps, ok = gather_geometry(homography, depth_values, H, W)
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.warp_grad_launch(
            g.data_ptr(), homography.data_ptr(), inv_maps.data_ptr(), ok.data_ptr(), depth_values.data_ptr(),
            out.data_ptr(), int(out.dtype == torch.bfloat16), out.shape[1], out.stride(0), out.stride(1),
            N, D, H, W, C, BOX_MARGIN, stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_grad kernel launch failed: {lib.warp_grad_error_string(err).decode()}")
    LAUNCHES += 1
    return result


def warp_grad(
    g: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth_values: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gradient of the plane-sweep warp with respect to the source features,
    for N (sample, source view) pairs: cotangent g [N, D, H, W, C],
    src_proj and ref_proj [N, 4, 4] f32, depth_values [N, D] f32 -> dsrc
    [N, H, W, C] f32, or written into ``out`` as ``warp_grad_cuda``
    describes (and returned). CPU tensors take the plain version; CUDA
    tensors launch K3 once for all pairs (g is cast to a contiguous f32
    tensor first), each pair's homography computed as the sweep kernel's
    wrapper computes it."""
    if g.device.type == "cpu":
        dsrc = warp_src_feature_grad(g, src_proj, ref_proj, depth_values)
        return dsrc if out is None else out.copy_(dsrc.reshape(out.shape))
    homography = torch.cat([homography_terms(torch.stack([ref_proj[n], src_proj[n]]).to(g.device))
                            for n in range(g.shape[0])])
    return warp_grad_cuda(g.float().contiguous(), homography, depth_values.float().contiguous(), out)
