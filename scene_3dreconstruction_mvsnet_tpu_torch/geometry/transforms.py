"""Projective geometry primitives on torch tensors (float32, batched).

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/geometry/transforms.py``:
projection composition K@E, the general 4x4 inverse, the integer-corner pixel
grid and the plane-sweep source-view sampling coordinates. Functions take and
return tensors on the caller's device.
"""

from __future__ import annotations

import torch


def compose_projection_matrix(intrinsics: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    """proj = [[K @ E[:3,:4]], [E[3,:4]]] for K [...,3,3], E [...,4,4] -> [...,4,4]."""
    top = torch.matmul(intrinsics, extrinsics[..., :3, :4])
    return torch.cat([top, extrinsics[..., 3:4, :4]], dim=-2)


def invert_4x4(mat: torch.Tensor) -> torch.Tensor:
    """General batched 4x4 inverse (projection matrices K@E are not rigid)."""
    return torch.linalg.inv(mat)


def pixel_grid(height: int, width: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Homogeneous pixel grid with integer-corner convention -> [3, H*W],
    rows (x, y, 1)."""
    y, x = torch.meshgrid(
        torch.arange(height, device=device, dtype=dtype),
        torch.arange(width, device=device, dtype=dtype),
        indexing="ij",
    )
    ones = torch.ones(height * width, device=device, dtype=dtype)
    return torch.stack([x.reshape(-1), y.reshape(-1), ones], dim=0)


def relative_projection(src_proj: torch.Tensor, ref_proj: torch.Tensor):
    """P = src_proj @ inv(ref_proj) for [B, 4, 4] inputs -> (rot [B, 3, 3],
    trans [B, 3]). The sweep kernel's wrapper takes its per-view homography
    from here too, so both paths start from the same f32 numbers."""
    proj = torch.matmul(src_proj, invert_4x4(ref_proj))
    return proj[:, :3, :3], proj[:, :3, 3]


def plane_sweep_coords(
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth_values: torch.Tensor,
    height: int,
    width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-view pixel coordinates for every (depth plane, ref pixel).

    A ref pixel (x, y) at hypothesis depth d maps to source homogeneous
    coords ``R @ (x, y, 1) * d + t`` with (R, t) from
    ``relative_projection``, then a perspective divide.

    Args:
      src_proj, ref_proj: [B, 4, 4] K@E.
      depth_values: [B, D].
      height, width: reference feature map size.

    Returns (x, y): two [B, D, H*W] float32 source pixel coordinate tensors.
    """
    rot, trans = relative_projection(src_proj, ref_proj)
    x, y, _ = pixel_grid(height, width, device=depth_values.device, dtype=depth_values.dtype)

    def comp(i):
        # R[i] . (x, y, 1) as elementwise ops in a fixed order (a GEMM would
        # pick its own), the order the sweep kernel evaluates
        r = rot[:, i, :, None]  # [B, 3, 1]
        rxy = (r[:, 0] * x + r[:, 1] * y) + r[:, 2]  # [B, HW]
        return rxy[:, None, :] * depth_values[:, :, None] + trans[:, i, None, None]

    z = comp(2)
    return comp(0) / z, comp(1) / z
