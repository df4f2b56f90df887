"""Scene kit: the bin's bounding boxes, camera poses, and the post-processing
of the fused cloud (crop to the bin's bounding box, statistical outlier
removal, voxel downsampling).

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/eval/scene_kit.py`` (host
numpy, as there). Same algorithms, same random candidate draws, same
results. The geometry is plain numpy; ``to_open3d`` hands a cloud to Open3D
where that package is installed (it is imported only by that call).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BBox(NamedTuple):
    min_bound: np.ndarray  # [3]
    max_bound: np.ndarray  # [3]

    def contains(self, points: np.ndarray) -> np.ndarray:
        """points [N, 3] -> bool [N]."""
        return np.all((points >= self.min_bound) & (points <= self.max_bound), axis=1)


def get_frame_bbox(
    dims: tuple[float, float, float] = (0.57, 0.37, 0.22),
    delta: tuple[float, float, float] = (0.0, 0.0, 0.0),
    scale: float = 1.0,
    context: str | None = None,
) -> tuple[BBox, BBox]:
    """Bin bounding boxes in mm: (inner walls, outer walls 20 mm further
    out, open at the top). A named ``context`` (an acquisition folder)
    selects the rig's preset offset."""
    if context is not None:
        dims = (0.57, 0.37, 0.22)
        delta = (0.08, 0.03, 0.0) if ("overhead03" in context or "overhead02" in context) else (0.0, 0.0, 0.0)
    dims_mm = np.asarray(dims, dtype=np.float64) * 1000.0 * scale
    delta_mm = np.asarray(delta, dtype=np.float64) * 1000.0 * scale
    min_b, max_b = -dims_mm / 2.0, dims_mm / 2.0
    max_b[2] -= min_b[2]
    min_b[2] = 0.0
    inner = BBox(min_b + delta_mm, max_b + delta_mm)
    wall = 20.0
    outer = BBox(inner.min_bound - wall, inner.max_bound + np.array([wall, wall, 0.0]))
    return inner, outer


def invert_pose(rotation: np.ndarray, translation: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(R | t) world->camera -> camera->world (R^T | -R^T t)."""
    rot = rotation.T
    return rot, -rot @ translation


def camera_poses(cam_extrinsics: list[np.ndarray]) -> list[dict]:
    """Each camera's centre and optical axis in world coordinates (the
    reference's arrow meshes, as data); the first camera is highlighted."""
    cams = []
    for i, E in enumerate(cam_extrinsics):
        R, t = invert_pose(E[:3, :3], E[:3, 3])
        cams.append({"center": R @ np.zeros(3) + t, "direction": R @ np.array([0.0, 0.0, 1.0]), "highlight": i == 0})
    return cams


def voxel_down_sample(
    points: np.ndarray, colors: np.ndarray | None = None, voxel_size: float = 5.0
) -> tuple[np.ndarray, np.ndarray | None]:
    """The mean point (and colour) of each ``voxel_size`` cell, cells in
    lexicographic order of their integer coordinates."""
    points = np.asarray(points, dtype=np.float64)
    if points.shape[0] == 0:
        return points.astype(np.float32), colors
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)

    def cell_mean(values):
        sums = np.zeros((counts.shape[0], values.shape[1]), np.float64)
        np.add.at(sums, inverse, values)
        return sums / counts[:, None]

    out_colors = None if colors is None else cell_mean(colors.astype(np.float64)).astype(colors.dtype)
    return cell_mean(points).astype(np.float32), out_colors


def remove_statistical_outliers(
    points: np.ndarray, nb_neighbors: int = 20, std_ratio: float = 2.0, cell_size: float | None = None,
) -> np.ndarray:
    """Keep mask [N]: a point stays when its mean distance to its
    ``nb_neighbors`` nearest candidates is at most mean + ``std_ratio`` *
    std over all points. Candidates come from the 3x3x3 cells of a spatial
    hash around the point's cell (at most 8 * ``nb_neighbors``, drawn from a
    generator seeded with 0)."""
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    if cell_size is None:
        vol = float(np.prod(np.maximum(np.ptp(points, axis=0), 1e-6)))
        cell_size = max((vol / n) ** (1.0 / 3.0) * nb_neighbors ** (1 / 3.0), 1e-6)

    keys = np.floor(points / cell_size).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind="stable")
    bounds = np.searchsorted(inverse[order], np.arange(uniq.shape[0] + 1))
    cell_index = {tuple(c): i for i, c in enumerate(uniq)}
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)]

    rng = np.random.RandomState(0)
    mean_dists = np.full(n, np.inf)
    for ci, cell in enumerate(uniq):
        members = order[bounds[ci]:bounds[ci + 1]]
        pool = [members]
        for dx, dy, dz in offsets:
            j = cell_index.get((cell[0] + dx, cell[1] + dy, cell[2] + dz))
            if j is not None:
                pool.append(order[bounds[j]:bounds[j + 1]])
        cand = np.concatenate(pool)
        if cand.shape[0] > 8 * nb_neighbors:
            cand = cand[rng.choice(cand.shape[0], 8 * nb_neighbors, replace=False)]
        if cand.shape[0] < 2:
            continue
        d = np.linalg.norm(points[members, None] - points[None, cand], axis=-1)
        k = min(nb_neighbors, d.shape[1] - 1)
        mean_dists[members] = np.partition(d, k, axis=1)[:, 1 : k + 1].mean(axis=1)

    finite = np.isfinite(mean_dists)
    mu = mean_dists[finite].mean() if finite.any() else 0.0
    sd = mean_dists[finite].std() if finite.any() else 0.0
    return mean_dists <= mu + std_ratio * sd


def postprocess_cloud(
    points: np.ndarray,
    colors: np.ndarray | None,
    *,
    crop_bbox: BBox | None = None,
    nb_neighbors: int = 20,
    std_ratio: float = 2.0,
    voxel_size: float = 5.0,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Crop to ``crop_bbox`` (if given), remove statistical outliers, voxel
    downsample: the reference's fused-cloud pipeline."""
    if crop_bbox is not None and points.shape[0]:
        keep = crop_bbox.contains(points)
        points, colors = points[keep], colors[keep] if colors is not None else None
    if points.shape[0]:
        keep = remove_statistical_outliers(points, nb_neighbors, std_ratio)
        points, colors = points[keep], colors[keep] if colors is not None else None
    return voxel_down_sample(points, colors, voxel_size)


def to_open3d(points: np.ndarray, colors: np.ndarray | None = None):
    """The cloud as an ``open3d.geometry.PointCloud`` (colours above 1 are
    taken as 0-255); raises ImportError where open3d is not installed."""
    import open3d as o3d

    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(np.asarray(points, dtype=np.float64))
    if colors is not None:
        c = np.asarray(colors, dtype=np.float64)
        if c.max() > 1.0:
            c = c / 255.0
        pcd.colors = o3d.utility.Vector3dVector(c)
    return pcd
