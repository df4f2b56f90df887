"""Synthetic multi-view scene generator.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/data/synthetic.py`` on
the port's own ``io``: for the same arguments every function writes the
same bytes as its counterpart there.

Renders a geometrically consistent slanted textured plane observed by a rig
of translated pinhole cameras, and writes it to disk in the reference's
dataset layouts (blender-train / dtu-train / unified-eval). This is the test
and benchmark fixture strategy from SURVEY.md §4(c): the text formats are
fully specified, so tiny scenes can be fabricated in tmpdirs and every
loader / pipeline / CLI path exercised without real DTU data.

Scene model: world plane  z = z0 + slope_x * x  (smooth procedural texture),
cameras at world positions (bx * v, 0, 0), identity rotation, shared
intrinsics. For camera v, the depth at pixel (u, vpix) solves

    d * (1 - slope_x * (u - cx) / fx) = z0 + slope_x * bx * v

which is exact (no sampling error), so depth maps are analytically correct
and plane-sweep inference should recover them.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.cams import write_pair_file
from ..io.images import save_image_u8, save_mask
from ..io.pfm import save_pfm


def _texture(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Smooth deterministic texture over world coords -> [0, 1]. Mixes low
    frequencies (structure) with mid frequencies (discrimination for the
    photometric plane sweep)."""
    t = (
        0.5
        + 0.14 * np.sin(0.11 * x) * np.cos(0.07 * y)
        + 0.10 * np.sin(0.031 * (x + 2.0 * y))
        + 0.10 * np.cos(0.053 * (1.7 * x - y))
        + 0.08 * np.sin(0.61 * x + 0.2) * np.cos(0.43 * y)
        + 0.07 * np.sin(0.83 * (0.6 * x - y) + 1.1)
    )
    return np.clip(t, 0.0, 1.0)


class SyntheticRig:
    """Analytic plane scene + camera rig."""

    def __init__(
        self,
        n_views: int = 4,
        img_hw: tuple[int, int] = (64, 96),
        z0: float = 50.0,
        slope_x: float = 0.15,
        baseline: float = 2.0,
        focal: float = 80.0,
    ) -> None:
        self.n_views = n_views
        self.img_hw = img_hw
        self.z0 = z0
        self.slope_x = slope_x
        self.baseline = baseline
        h, w = img_hw
        self.K = np.array(
            [[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    def extrinsics(self, view: int) -> np.ndarray:
        """World->camera for camera at world x = baseline * view."""
        E = np.eye(4, dtype=np.float32)
        E[0, 3] = -self.baseline * view
        return E

    def depth_map(self, view: int, scale: int = 1) -> np.ndarray:
        """Analytic depth at (optionally downsampled) pixel centers.

        scale>1 evaluates at the pixel grid of the subsampled image
        (matching [::scale, ::scale] pixel positions, i.e. integer pixel
        coords 0, scale, 2*scale, ...).
        """
        h, w = self.img_hw
        us = np.arange(0, w, scale, dtype=np.float64)
        vs = np.arange(0, h, scale, dtype=np.float64)
        u, _ = np.meshgrid(us, vs)
        fx, cx = self.K[0, 0], self.K[0, 2]
        num = self.z0 + self.slope_x * self.baseline * view
        den = 1.0 - self.slope_x * (u - cx) / fx
        return (num / den).astype(np.float32)

    def render(self, view: int) -> np.ndarray:
        """Render the view by evaluating the world texture exactly."""
        h, w = self.img_hw
        u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
        d = self.depth_map(view).astype(np.float64)
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        x_cam = (u - cx) / fx * d
        y_cam = (v - cy) / fy * d
        x_w = x_cam + self.baseline * view
        y_w = y_cam
        img = _texture(x_w, y_w).astype(np.float32)
        return np.dstack([img, img, img])

    def depth_range(self) -> tuple[float, float]:
        lo = min(self.depth_map(v).min() for v in range(self.n_views))
        hi = max(self.depth_map(v).max() for v in range(self.n_views))
        return float(lo), float(hi)

    def pair_list(self) -> list[tuple[int, list[int]]]:
        pairs = []
        for ref in range(self.n_views):
            srcs = sorted(
                (v for v in range(self.n_views) if v != ref),
                key=lambda v: abs(v - ref),
            )
            pairs.append((ref, srcs))
        return pairs

    def write_cam_file(self, path: str, view: int, ndepths: int = 32,
                       intrinsics_scale: float = 1.0) -> None:
        lo, hi = self.depth_range()
        margin = 0.15 * (hi - lo) + 1.0
        depth_min = lo - margin
        depth_interval = (hi - lo + 2 * margin) / ndepths
        K = self.K.copy()
        K[:2, :] *= intrinsics_scale
        E = self.extrinsics(view)
        lines = ["extrinsic"]
        lines += [" ".join(f"{x:.8f}" for x in row) for row in E]
        lines += ["", "intrinsic"]
        lines += [" ".join(f"{x:.8f}" for x in row) for row in K]
        lines += ["", f"{depth_min:.6f} {depth_interval:.6f}"]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


def _look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World->camera extrinsic for a camera at ``eye`` looking at ``target``
    (same convention as bench.py's headline ring)."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    E = np.eye(4)
    R = np.stack([x, y, z])
    E[:3, :3] = R
    E[:3, 3] = -R @ eye
    return E.astype(np.float32)


class RingRig(SyntheticRig):
    """Inward-looking camera ring over the textured plane — the DTU/BDS8
    overhead acquisition geometry (the reference's eval.py:851-895 BDS8
    rigs; 49 cameras in the shipped pair files). Rotation-bearing
    extrinsics stress the sweep kernel's window planner (per-view yspan
    envelopes) where the translation rig is the gather-friendliest case.

    Cameras sit on a circle of ``radius`` at z = ``height``, all looking at
    the plane center (0, 0, z0); the scene is the analytic textured plane
    z = z0 + slope_x * x, so depth maps and renders stay exact closed forms
    (ray-plane intersection)."""

    def __init__(
        self,
        n_views: int = 49,
        img_hw: tuple[int, int] = (512, 640),
        z0: float = 700.0,
        slope_x: float = 0.05,
        radius: float = 150.0,
        height: float = -700.0,
        focal: float | None = None,
    ) -> None:
        super().__init__(
            n_views=n_views, img_hw=img_hw, z0=z0, slope_x=slope_x,
            baseline=0.0, focal=focal if focal is not None else 1.1 * img_hw[1],
        )
        self.radius = radius
        self.height = height

    def extrinsics(self, view: int) -> np.ndarray:
        a = 2.0 * np.pi * view / self.n_views
        eye = (self.radius * np.cos(a), self.radius * np.sin(a), self.height)
        return _look_at(eye, (0.0, 0.0, self.z0))

    def _plane_hits(self, view: int, scale: int = 1):
        """(depth [h,w], world x [h,w], world y [h,w]) at pixel centers:
        cam-space z of the ray/plane intersection and its world x/y."""
        h, w = self.img_hw
        us = np.arange(0, w, scale, dtype=np.float64)
        vs = np.arange(0, h, scale, dtype=np.float64)
        u, v = np.meshgrid(us, vs)
        Kinv = np.linalg.inv(self.K.astype(np.float64))
        d_cam = np.stack([u, v, np.ones_like(u)], axis=-1) @ Kinv.T  # z comp 1
        E = self.extrinsics(view).astype(np.float64)
        R = E[:3, :3]
        o = -R.T @ E[:3, 3]  # camera center in world
        d_w = d_cam @ R  # == (R.T @ d_cam^T)^T
        # plane z = z0 + slope_x * x:  o_z + s d_z = z0 + slope_x (o_x + s d_x)
        s = (self.z0 + self.slope_x * o[0] - o[2]) / (
            d_w[..., 2] - self.slope_x * d_w[..., 0]
        )
        # cam point = s * d_cam (z component 1) => cam-space depth = s
        x_w = o[0] + s * d_w[..., 0]
        y_w = o[1] + s * d_w[..., 1]
        return s, x_w, y_w

    def depth_map(self, view: int, scale: int = 1) -> np.ndarray:
        return self._plane_hits(view, scale)[0].astype(np.float32)

    def render(self, view: int) -> np.ndarray:
        _, x_w, y_w = self._plane_hits(view)
        img = _texture(0.1 * x_w, 0.1 * y_w).astype(np.float32)
        return np.dstack([img, img, img])

    def pair_list(self) -> list[tuple[int, list[int]]]:
        """Nearest neighbours by CIRCULAR camera distance (ring topology)."""
        n = self.n_views
        pairs = []
        for ref in range(n):
            srcs = sorted(
                (v for v in range(n) if v != ref),
                key=lambda v: min((v - ref) % n, (ref - v) % n),
            )
            pairs.append((ref, srcs))
        return pairs


def make_blender_tree(root: str, scan: str = "scene_000", n_lights: int = 2,
                      rig: SyntheticRig | None = None, ndepths: int = 32) -> SyntheticRig:
    """Blender-train layout (the reference's datasets/blender.py:131-134):
    Cameras_512x640/, Rectified_512x640/, Depths_512x640/ with full-res
    depth/mask (the loader subsamples [::4])."""
    rig = rig or SyntheticRig()
    cam_dir = os.path.join(root, "Cameras_512x640")
    img_dir = os.path.join(root, "Rectified_512x640", scan)
    dep_dir = os.path.join(root, "Depths_512x640", scan)
    for d in (cam_dir, img_dir, dep_dir):
        os.makedirs(d, exist_ok=True)

    write_pair_file(os.path.join(cam_dir, "pair.txt"), rig.pair_list())
    for v in range(rig.n_views):
        rig.write_cam_file(os.path.join(cam_dir, f"{v:0>8}_cam.txt"), v, ndepths)
        img = rig.render(v)
        for light in range(n_lights):
            save_image_u8(
                os.path.join(img_dir, f"rect_C{v:0>3}_L{light:0>2}.png"), img
            )
        save_pfm(os.path.join(dep_dir, f"depth_map_{v:0>3}.pfm"), rig.depth_map(v))
        save_mask(
            os.path.join(dep_dir, f"depth_mask_{v:0>3}.png"),
            np.ones(rig.img_hw, dtype=bool),
        )
    return rig


def make_dtu_tree(root: str, scan: str = "scan1", rig: SyntheticRig | None = None,
                  ndepths: int = 32) -> SyntheticRig:
    """DTU-train layout (the reference's datasets/dtu_yao.py:88-91): cam
    files carry feature-scale intrinsics (1/4), depth/mask stored at 1/4
    resolution."""
    rig = rig or SyntheticRig()
    cam_dir = os.path.join(root, "Cameras", "train")
    img_dir = os.path.join(root, "Rectified", f"{scan}_train")
    dep_dir = os.path.join(root, "Depths", f"{scan}_train")
    for d in (cam_dir, img_dir, dep_dir):
        os.makedirs(d, exist_ok=True)

    write_pair_file(os.path.join(root, "Cameras", "pair.txt"), rig.pair_list())
    for v in range(rig.n_views):
        rig.write_cam_file(
            os.path.join(cam_dir, f"{v:0>8}_cam.txt"), v, ndepths, intrinsics_scale=0.25
        )
        img = rig.render(v)
        for light in range(7):
            save_image_u8(
                os.path.join(img_dir, f"rect_{v + 1:0>3}_{light}_r5000.png"), img
            )
        save_pfm(os.path.join(dep_dir, f"depth_map_{v:0>4}.pfm"), rig.depth_map(v, scale=4))
        h, w = rig.img_hw
        save_mask(
            os.path.join(dep_dir, f"depth_visual_{v:0>4}.png"),
            np.ones((h // 4, w // 4), dtype=bool),
        )
    return rig


def make_eval_tree(root: str, scan: str = "scan1", rig: SyntheticRig | None = None,
                   ndepths: int = 32) -> SyntheticRig:
    """Unified-eval layout for data.dataloader_eval with cam_subfolder
    'Cameras', img_subfolder 'Rectified/{}/rect_C{:0>3}_L00.png'."""
    rig = rig or SyntheticRig()
    cam_dir = os.path.join(root, "Cameras")
    img_dir = os.path.join(root, "Rectified", scan)
    for d in (cam_dir, img_dir):
        os.makedirs(d, exist_ok=True)

    write_pair_file(os.path.join(root, "pair.txt"), rig.pair_list())
    for v in range(rig.n_views):
        rig.write_cam_file(os.path.join(cam_dir, f"{v:0>8}_cam.txt"), v, ndepths)
        save_image_u8(
            os.path.join(img_dir, f"rect_C{v:0>3}_L00.png"), rig.render(v)
        )
    return rig


def make_legacy_dtu_eval_tree(root: str, scan: str = "scan1",
                              rig: SyntheticRig | None = None,
                              ndepths: int = 8) -> SyntheticRig:
    """Legacy DTU eval layout (data.dtu_yao_eval + evalDTU.py):
    Rectified_raw/{scan}/rect_{vid+1:0>3}_3_r5000.png at 1200x1600 (the
    loader asserts this exact shape and crops the bottom 16 rows), shared
    Cameras/{vid:0>8}_cam.txt with FULL-res intrinsics (the loader divides
    by 4 at read), and the pair file inside Cameras/."""
    rig = rig or SyntheticRig(n_views=3, img_hw=(1200, 1600), z0=500.0,
                              slope_x=0.1, baseline=25.0, focal=1100.0)
    assert rig.img_hw == (1200, 1600), "legacy DTU eval is 1200x1600-only"
    cam_dir = os.path.join(root, "Cameras")
    img_dir = os.path.join(root, "Rectified_raw", scan)
    for d in (cam_dir, img_dir):
        os.makedirs(d, exist_ok=True)

    write_pair_file(os.path.join(cam_dir, "pair.txt"), rig.pair_list())
    for v in range(rig.n_views):
        rig.write_cam_file(os.path.join(cam_dir, f"{v:0>8}_cam.txt"), v, ndepths)
        save_image_u8(
            os.path.join(img_dir, f"rect_{v + 1:0>3}_3_r5000.png"), rig.render(v)
        )
    return rig


def write_scan_list(path: str, scans: list[str]) -> None:
    with open(path, "w") as f:
        f.write("\n".join(scans) + "\n")
