"""Photometric and geometric consistency filter, plain torch on the device.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/eval/filtering.py``: a
reference view's depth is projected into each source view, the source depth
is sampled there, and the point is projected back (the reference's
``reproject_with_depth``). A pixel is consistent with a source when the
round trip lands within ``condmask_pixel`` px and its depth within
``condmask_depth`` (relative); the fused depth is the mean of the
reference's depth and the consistent reprojections.

Semantics, as in the JAX package:
 - the reference pixel grid has integer corners (``pixel_grid``);
 - the source depth is sampled bilinearly with a zero border
   (``bilinear_sample_map``, cv2.remap's BORDER_CONSTANT);
 - everything is f32, and the camera products are explicit f32 multiply-adds
   (``matmul_f32``), which no TF32 setting reaches, where the JAX package
   uses ``Precision.HIGHEST`` matmuls.

Functions take batch dims in front of [H, W] and broadcast them, so a chunk
of reference views meets all its source views in one set of tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..geometry.transforms import invert_4x4, matmul_f32, pixel_grid
from ..ops.sampling import bilinear_sample_map
from ..parallel.sharding import shard_rows


def _homogeneous(xyz: torch.Tensor) -> torch.Tensor:
    """[..., k, N] -> [..., k + 1, N] with a row of ones."""
    return torch.cat([xyz, torch.ones_like(xyz[..., :1, :])], dim=-2)


def reproject_with_depth(
    depth_ref: torch.Tensor,
    intrinsics_ref: torch.Tensor,
    extrinsics_ref: torch.Tensor,
    depth_src: torch.Tensor,
    intrinsics_src: torch.Tensor,
    extrinsics_src: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Project the reference depth into the source, sample the source depth
    there, and project back. Depths [..., H, W], K [..., 3, 3], E [..., 4, 4]
    (batch dims broadcast) -> (depth_reprojected, x2d_reprojected,
    y2d_reprojected, x2d_src, y2d_src), each [..., H, W]: the reference's
    5-tuple."""
    H, W = depth_ref.shape[-2:]
    grid = pixel_grid(H, W, device=depth_ref.device)  # [3, HW]
    # reference pixels -> reference camera -> source camera -> source pixels
    xyz_ref = matmul_f32(invert_4x4(intrinsics_ref), grid * depth_ref.reshape(*depth_ref.shape[:-2], 1, H * W))
    rel = matmul_f32(extrinsics_src, invert_4x4(extrinsics_ref))
    xyz_src = matmul_f32(rel, _homogeneous(xyz_ref))[..., :3, :]
    k_xyz_src = matmul_f32(intrinsics_src, xyz_src)
    xy_src = k_xyz_src[..., :2, :] / k_xyz_src[..., 2:3, :]  # [..., 2, HW]

    lead = xy_src.shape[:-2]
    sampled = bilinear_sample_map(depth_src.expand(*lead, H, W), xy_src[..., 0, :], xy_src[..., 1, :])

    # back-project with the sampled source depth and return to the reference
    xyz_src2 = matmul_f32(invert_4x4(intrinsics_src), _homogeneous(xy_src) * sampled[..., None, :])
    rel_back = matmul_f32(extrinsics_ref, invert_4x4(extrinsics_src))
    xyz_reproj = matmul_f32(rel_back, _homogeneous(xyz_src2))[..., :3, :]
    k_xyz_reproj = matmul_f32(intrinsics_ref, xyz_reproj)
    xy_reproj = k_xyz_reproj[..., :2, :] / k_xyz_reproj[..., 2:3, :]

    def hw(t):
        return t.reshape(*lead, H, W)

    return hw(xyz_reproj[..., 2, :]), hw(xy_reproj[..., 0, :]), hw(xy_reproj[..., 1, :]), \
        hw(xy_src[..., 0, :]), hw(xy_src[..., 1, :])


def check_geometric_consistency(
    depth_ref,
    intrinsics_ref,
    extrinsics_ref,
    depth_src,
    intrinsics_src,
    extrinsics_src,
    condmask_pixel: float = 1.0,
    condmask_depth: float = 0.01,
):
    """-> (mask, the reprojected depth where masked else 0, x2d_src,
    y2d_src), each [..., H, W]."""
    H, W = depth_ref.shape[-2:]
    depth_reproj, x_rp, y_rp, x_src, y_src = reproject_with_depth(
        depth_ref, intrinsics_ref, extrinsics_ref, depth_src, intrinsics_src, extrinsics_src,
    )
    grid = pixel_grid(H, W, device=depth_ref.device)
    dist = torch.sqrt((x_rp - grid[0].reshape(H, W)) ** 2 + (y_rp - grid[1].reshape(H, W)) ** 2)
    relative = (depth_reproj - depth_ref).abs() / depth_ref
    mask = (dist < condmask_pixel) & (relative < condmask_depth)
    return mask, torch.where(mask, depth_reproj, 0.0), x_src, y_src


def geometric_filter_stack(
    depth_ref: torch.Tensor,
    intrinsics_ref: torch.Tensor,
    extrinsics_ref: torch.Tensor,
    depths_src: torch.Tensor,
    intrinsics_src: torch.Tensor,
    extrinsics_src: torch.Tensor,
    condmask_pixel: float = 1.0,
    condmask_depth: float = 0.01,
):
    """One reference view [H, W] against all its source views at once:
    depths_src [N, H, W], intrinsics_src [N, 3, 3], extrinsics_src [N, 4, 4]
    -> (geo_mask_sum int32 [H, W], depth_reproj_sum [H, W], per-view masks
    bool [N, H, W])."""
    masks, depths_reproj, _, _ = check_geometric_consistency(
        depth_ref, intrinsics_ref, extrinsics_ref, depths_src, intrinsics_src, extrinsics_src,
        condmask_pixel, condmask_depth,
    )
    return masks.sum(dim=0, dtype=torch.int32), depths_reproj.sum(dim=0), masks


def _fuse_refs(d_ref, conf_ref, K_ref, E_ref, d_src, K_src, E_src, src_valid,
               photomask, geomask, condmask_pixel, condmask_depth):
    """R reference views [R, H, W] against their N source views [R, N, H, W]
    (K [.., 3, 3], E [.., 4, 4]); ``src_valid`` [R, N] masks padded slots ->
    (photo, geo, final masks, depth_est_averaged, geo count), each [R, H, W]."""
    masks, d_reproj, _, _ = check_geometric_consistency(
        d_ref[:, None], K_ref[:, None], E_ref[:, None], d_src, K_src, E_src, condmask_pixel, condmask_depth,
    )
    masks = masks & src_valid[:, :, None, None]
    geo_sum = masks.sum(dim=1, dtype=torch.int32)
    depth_avg = (torch.where(masks, d_reproj, 0.0).sum(dim=1) + d_ref) / (geo_sum + 1)
    photo = conf_ref > photomask
    geo = geo_sum >= geomask
    return photo, geo, photo & geo, depth_avg.float(), geo_sum


def fuse_scan(
    depths: np.ndarray,
    confidences: np.ndarray,
    Ks: np.ndarray,
    Es: np.ndarray,
    pair_data: list[tuple[int, list[int]]],
    view_ids: list[int],
    *,
    NviewFilter: int = 10,
    photomask: float = 0.8,
    geomask: int = 3,
    condmask_pixel: float = 1.0,
    condmask_depth: float = 0.01,
    ref_chunk: int = 8,
    device: torch.device | str = "cuda",
    devices: list[torch.device | str] | None = None,
    group=None,
) -> list[dict]:
    """Whole-scan filter on ``device``: ``depths``/``confidences`` [V, H, W]
    and ``Ks`` [V, 3, 3], ``Es`` [V, 4, 4] stacked in ``view_ids`` order,
    ``pair_data`` the parsed pair file. Ragged source lists are padded to
    one width and masked; reference views run ``ref_chunk`` at a time to
    bound device memory. Returns per-reference-view dicts of numpy arrays
    (photo_mask, geo_mask, final_mask, depth_est_averaged) in pair order.

    The reference-view axis may be split, as the JAX package's ``mesh``
    splits it: over ``devices`` (each holds every view's maps and filters
    its contiguous share; every share is launched before any is read back),
    or over the ranks of a process ``group`` (each rank filters its share
    on ``device`` and the shares are gathered, so every rank returns every
    view's masks). The results equal the serial filter's."""
    id_to_row = {v: i for i, v in enumerate(view_ids)}
    R = len(pair_data)
    width = max(1, min(NviewFilter, max(len(s) for _, s in pair_data)))
    ref_idx = np.zeros((R,), np.int64)
    src_idx = np.zeros((R, width), np.int64)
    src_valid = np.zeros((R, width), bool)
    for i, (ref_view, src_views) in enumerate(pair_data):
        ref_idx[i] = id_to_row[ref_view]
        srcs = [id_to_row[s] for s in src_views[:NviewFilter]]
        for j in range(width):
            src_idx[i, j] = srcs[j] if j < len(srcs) else srcs[0] if srcs else 0
            src_valid[i, j] = j < len(srcs)

    if devices is not None and group is not None:
        raise ValueError("fuse_scan splits the reference views over devices or over a process group, not both")
    thresholds = (photomask, geomask, condmask_pixel, condmask_depth)

    def launch(rows: slice, on) -> list[torch.Tensor]:
        """The filter of reference views ``rows`` on device ``on`` ->
        (photo, geo, final, depth_avg) on that device, not yet read back."""
        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(on)

        depths_t, confs_t, Ks_t, Es_t = dev(depths), dev(confidences), dev(Ks), dev(Es)
        ref_t, src_t, valid_t = (dev(a[rows], t) for a, t in ((ref_idx, torch.int64), (src_idx, torch.int64),
                                                               (src_valid, torch.bool)))
        outs = []
        with torch.inference_mode():
            for c in range(0, len(ref_t), max(1, ref_chunk)):
                r, s = ref_t[c : c + ref_chunk], src_t[c : c + ref_chunk]
                outs.append(_fuse_refs(depths_t[r], confs_t[r], Ks_t[r], Es_t[r], depths_t[s], Ks_t[s], Es_t[s],
                                       valid_t[c : c + ref_chunk], *thresholds)[:4])
        return [torch.cat(parts) for parts in zip(*outs)]

    if group is not None:
        world = dist.get_world_size(group)
        per = -(-R // world)  # every rank's share padded to one size for the gather
        pad = per * world - R
        ref_idx, src_idx, src_valid = (np.concatenate([a, np.repeat(a[:1], pad, 0)])
                                       for a in (ref_idx, src_idx, src_valid))
        mine = launch(shard_rows(per * world, dist.get_rank(group), world), device)
        gathered = []
        for t in mine:
            t = t.to(torch.uint8) if t.dtype == torch.bool else t  # one wire type for every backend
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t.contiguous(), group=group)
            gathered.append(torch.cat(parts)[:R].cpu().numpy())
        photo, geo, final = (g.astype(bool) for g in gathered[:3])
        depth_avg = gathered[3]
    else:
        if devices is None:
            shares = [(slice(0, R), device)]
        else:  # contiguous shares, as many as the devices, the last ones smaller
            per = -(-R // len(devices))
            shares = [(slice(i * per, min(R, (i + 1) * per)), d) for i, d in enumerate(devices) if i * per < R]
        launched = [launch(rows, on) for rows, on in shares]  # every share queued before any is read back
        photo, geo, final, depth_avg = (np.concatenate([out[i].cpu().numpy() for out in launched])
                                        for i in range(4))
    return [
        {"photo_mask": photo[i], "geo_mask": geo[i], "final_mask": final[i], "depth_est_averaged": depth_avg[i]}
        for i in range(R)
    ]


def fuse_reference_view(
    ref_depth: np.ndarray,
    confidence: np.ndarray,
    ref_intrinsics: np.ndarray,
    ref_extrinsics: np.ndarray,
    src_depths: np.ndarray,
    src_intrinsics: np.ndarray,
    src_extrinsics: np.ndarray,
    photomask: float = 0.8,
    geomask: int = 3,
    condmask_pixel: float = 1.0,
    condmask_depth: float = 0.01,
    device: torch.device | str = "cuda",
) -> dict:
    """One reference view's filter against all its sources (numpy in and
    out, the compute on ``device``) -> photo_mask, geo_mask, final_mask
    (bool [H, W]), depth_est_averaged [H, W] and geo_mask_sum [H, W]."""

    def dev(a):  # a copy: read_pfm's arrays are flipped views with negative strides
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32)).to(device)[None]

    with torch.inference_mode():
        photo, geo, final, depth_avg, geo_sum = _fuse_refs(
            dev(ref_depth), dev(confidence), dev(ref_intrinsics), dev(ref_extrinsics),
            dev(src_depths), dev(src_intrinsics), dev(src_extrinsics),
            torch.ones((1, len(src_depths)), dtype=torch.bool, device=device),
            photomask, geomask, condmask_pixel, condmask_depth,
        )
    out = {"photo_mask": photo, "geo_mask": geo, "final_mask": final, "depth_est_averaged": depth_avg,
           "geo_mask_sum": geo_sum}
    return {k: v[0].cpu().numpy() for k, v in out.items()}
