"""Projective geometry primitives on torch tensors (float32, batched).

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/geometry/transforms.py``:
projection composition K@E, the exact rigid and the general 4x4 inverses, the
projection of world points into a camera, the integer-corner pixel
grid (the sweep and the consistency filter), the half-pixel-centre grid and
the back-projection of depth maps to world points (fusion), and the
plane-sweep source-view sampling coordinates. Functions take and return
tensors on the caller's device.
"""

from __future__ import annotations

import torch


def compose_projection_matrix(intrinsics: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    """proj = [[K @ E[:3,:4]], [E[3,:4]]] for K [...,3,3], E [...,4,4] -> [...,4,4]."""
    top = torch.matmul(intrinsics, extrinsics[..., :3, :4])
    return torch.cat([top, extrinsics[..., 3:4, :4]], dim=-2)


def invert_rigid(extrinsics: torch.Tensor) -> torch.Tensor:
    """Invert rigid-body [..., 4, 4] (R | t) matrices exactly: (R^T | -R^T t)."""
    rt = extrinsics[..., :3, :3].transpose(-1, -2)
    top = torch.cat([rt, -matmul_f32(rt, extrinsics[..., :3, 3:4])], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=extrinsics.dtype, device=extrinsics.device)
    return torch.cat([top, bottom.expand(*top.shape[:-2], 1, 4)], dim=-2)


def invert_4x4(mat: torch.Tensor) -> torch.Tensor:
    """General batched square inverse (projection matrices K@E are not
    rigid); also takes the 3x3 intrinsics and rotations. ``inv_ex`` is
    ``inv``'s kernel without its singularity check, which on a card would
    wait for the device to finish all work queued before it."""
    return torch.linalg.inv_ex(mat)[0]


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


def pixel_grid_centered(height: int, width: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Homogeneous pixel grid with the half-pixel-centre convention (x + 0.5,
    y + 0.5, 1) -> [3, H*W]: the back-projection's grid (the reference's
    ``get_pixel_grids_np``). The consistency filter uses ``pixel_grid``'s
    integer corners instead."""
    y, x = torch.meshgrid(
        torch.arange(height, device=device, dtype=dtype) + 0.5,
        torch.arange(width, device=device, dtype=dtype) + 0.5,
        indexing="ij",
    )
    ones = torch.ones(height * width, device=device, dtype=dtype)
    return torch.stack([x.reshape(-1), y.reshape(-1), ones], dim=0)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., r, k] @ b [..., k, n] (batch dims broadcast) as explicit f32
    products summed over k in order. The camera algebra of the eval filter
    and the fusion uses this instead of ``torch.matmul``: the JAX package
    runs those products at ``Precision.HIGHEST``, and a card's matmul may
    round to TF32, whereas elementwise ops never do."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for i in range(1, a.shape[-1]):
        out = out + a[..., :, i : i + 1] * b[..., i : i + 1, :]
    return out


def depth_to_world_points(
    depth_map: torch.Tensor,
    intrinsics: torch.Tensor,
    extrinsics: torch.Tensor,
    xy_scale: float = 1.0531,
) -> torch.Tensor:
    """Back-project depth maps [..., H, W] with K [..., 3, 3] and world->camera
    E [..., 4, 4] to world points [..., H*W, 3] (batch dims broadcast), at the
    half-pixel centres, with the reference's empirical 1.0531 scale on world
    x and y (``xy_scale=1.0`` for unscaled geometry)."""
    h, w = depth_map.shape[-2:]
    grid = pixel_grid_centered(h, w, device=depth_map.device, dtype=depth_map.dtype)
    uv = matmul_f32(invert_4x4(intrinsics), grid)  # [..., 3, HW]
    cam = uv * depth_map.reshape(*depth_map.shape[:-2], 1, h * w)
    rot, trans = extrinsics[..., :3, :3], extrinsics[..., :3, 3:4]
    world = matmul_f32(invert_4x4(rot), cam - trans).transpose(-1, -2)  # [..., HW, 3]
    if xy_scale != 1.0:
        world = torch.cat([world[..., :2] * xy_scale, world[..., 2:]], dim=-1)
    return world


def project_points(
    xyz_world_h: torch.Tensor, intrinsics: torch.Tensor, extrinsics: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project homogeneous world points [4, N] into a camera (K [3, 3], E
    [4, 4]) -> (pixel coordinates xy [2, N], camera-frame depth [N])."""
    cam = matmul_f32(extrinsics, xyz_world_h)[:3]
    k_xyz = matmul_f32(intrinsics, cam)
    return k_xyz[:2] / k_xyz[2:3], cam[2]


def relative_projection(src_proj: torch.Tensor, ref_proj: torch.Tensor, ref_inv: torch.Tensor | None = None):
    """P = src_proj @ inv(ref_proj) for [B, 4, 4] inputs -> (rot [B, 3, 3],
    trans [B, 3]); ``ref_inv`` is ``invert_4x4(ref_proj)`` where the caller
    has it already. The sweep kernel's wrapper takes its per-view homography
    from here too, so both paths start from the same f32 numbers."""
    proj = torch.matmul(src_proj, invert_4x4(ref_proj) if ref_inv is None else ref_inv)
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
      depth_values: [B, D], or one depth per plane and pixel [B, D, H, W]
        (CasMVSNet's later stages); the same depths give the same bits
        either way.
      height, width: reference feature map size.

    Returns (x, y): two [B, D, H*W] float32 source pixel coordinate tensors.
    """
    rot, trans = relative_projection(src_proj, ref_proj)
    x, y, _ = pixel_grid(height, width, device=depth_values.device, dtype=depth_values.dtype)
    B, D = depth_values.shape[:2]
    depth = depth_values[:, :, None] if depth_values.dim() == 2 else depth_values.reshape(B, D, height * width)

    def comp(i):
        # R[i] . (x, y, 1) as elementwise ops in a fixed order (a GEMM would
        # pick its own), the order the sweep kernel evaluates
        r = rot[:, i, :, None]  # [B, 3, 1]
        rxy = (r[:, 0] * x + r[:, 1] * y) + r[:, 2]  # [B, HW]
        return rxy[:, None, :] * depth + trans[:, i, None, None]

    z = comp(2)
    return comp(0) / z, comp(1) / z
