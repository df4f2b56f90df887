"""The benchmark's inputs, made from the seed.

A frozen copy of the scene model of the port's ``data/synthetic.py``: a
textured plane z = z0 + slope * x (world millimetres) seen by pinhole
cameras, rendered exactly by ray-plane intersection, with the same
procedural texture. Every image, camera and depth map here is computed in
torch float64 on the given device, many images per call; only the pools'
scene parameters are drawn on the host (numpy, from the seed). Each seed gives
other scenes at the same sizes, so every seed asks the program for the same
work.

Three pools, one per kind of traffic: training batches (a translation rig,
as the DTU training recipe's), serving requests (views of a 49-camera ring,
as DTU's overhead rig), and eval scans written as the bin registry's file
tree (a 4-camera ring).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch


def texture(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``data/synthetic.py::_texture``: a smooth texture over world
    coordinates -> [0, 1]."""
    t = (
        0.5
        + 0.14 * torch.sin(0.11 * x) * torch.cos(0.07 * y)
        + 0.10 * torch.sin(0.031 * (x + 2.0 * y))
        + 0.10 * torch.cos(0.053 * (1.7 * x - y))
        + 0.08 * torch.sin(0.61 * x + 0.2) * torch.cos(0.43 * y)
        + 0.07 * torch.sin(0.83 * (0.6 * x - y) + 1.1)
    )
    return t.clamp(0.0, 1.0)


def intrinsics(focal: float, h: int, w: int) -> np.ndarray:
    return np.array([[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]])


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World->camera [4, 4] (f64) of a camera at ``eye`` looking at ``target``."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    E = np.eye(4)
    R = np.stack([x, np.cross(z, x), z])
    E[:3, :3] = R
    E[:3, 3] = -R @ eye
    return E


def ring_extrinsics(n: int, radius: float, height: float, target_z: float) -> np.ndarray:
    """[n, 4, 4]: an inward-looking ring of ``n`` cameras."""
    return np.stack([look_at((radius * math.cos(2 * math.pi * i / n), radius * math.sin(2 * math.pi * i / n), height),
                             (0.0, 0.0, target_z)) for i in range(n)])


def translation_extrinsics(positions) -> np.ndarray:
    """[n, 4, 4]: identity rotation, cameras at world x = ``positions``."""
    E = np.tile(np.eye(4), (len(positions), 1, 1))
    E[:, 0, 3] = -np.asarray(positions, np.float64)
    return E


def render(K: np.ndarray, E: np.ndarray, scene: np.ndarray, h: int, w: int, device,
           chunk: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Render images of the plane. K [N, 3, 3], E [N, 4, 4] world->camera,
    scene [N, 5] rows (z0, slope, texture scale, texture x offset, texture y
    offset) -> (u8 images [N, h, w, 3], camera-space depth [N, h, w] f32),
    both on ``device``, at the integer pixel positions."""
    imgs, depths = [], []
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                          torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], dim=-1)  # [h, w, 3]
    for i in range(0, len(K), chunk):
        Kc = torch.as_tensor(K[i:i + chunk], dtype=torch.float64, device=device)
        Ec = torch.as_tensor(E[i:i + chunk], dtype=torch.float64, device=device)
        sc = torch.as_tensor(scene[i:i + chunk], dtype=torch.float64, device=device)
        R, t = Ec[:, :3, :3], Ec[:, :3, 3]
        origin = -(R.transpose(1, 2) @ t[..., None])[..., 0]  # [n, 3] camera centres in the world
        ray = torch.einsum("hwk,nck,ncj->nhwj", pix, torch.linalg.inv(Kc), R)  # world directions, camera z = 1
        z0, slope, scale, ox, oy = (sc[:, j, None, None] for j in range(5))
        o = origin[:, None, None, :]
        s = (z0 + slope * o[..., 0] - o[..., 2]) / (ray[..., 2] - slope * ray[..., 0])
        x_w = o[..., 0] + s * ray[..., 0]
        y_w = o[..., 1] + s * ray[..., 1]
        img = torch.round(texture(scale * x_w + ox, scale * y_w + oy) * 255.0).to(torch.uint8)
        imgs.append(img[..., None].expand(-1, -1, -1, 3))
        depths.append(s.float())
    return torch.cat(imgs).contiguous(), torch.cat(depths)


def feature_proj(K: np.ndarray, E: np.ndarray) -> np.ndarray:
    """K @ E [..., 4, 4] f32 at feature resolution (the intrinsics' first two
    rows divided by 4, as the loaders do)."""
    K4 = np.array(K, np.float64)
    K4[..., :2, :] /= 4.0
    P = np.array(E, np.float64)
    P[..., :3, :4] = K4 @ P[..., :3, :4]
    return P.astype(np.float32)


def depth_hypotheses(depth_min: float, interval: float, numdepth: int) -> np.ndarray:
    """The loaders' planes: ``np.arange`` in f32 from ``depth_min`` by
    ``interval`` (already scaled by the interval scale), as the port's and
    the reference's datasets make them; refuses a depth line that gives
    another number of planes than ``numdepth``."""
    planes = np.arange(depth_min, interval * (numdepth - 0.5) + depth_min, interval, dtype=np.float32)
    if len(planes) != numdepth:
        raise ValueError(f"depth line ({depth_min}, {interval}) gives {len(planes)} planes, not {numdepth}")
    return planes


def _scene_rows(rng: np.random.Generator, n: int, traffic: dict) -> np.ndarray:
    """[n, 5] scene rows: z0 and slope uniform in the traffic's ranges, the
    texture's scale in its ``texture_scale`` range (default [0.8, 1.25]),
    its offsets in [0, 1000) mm."""
    z0, slope = traffic["z0_mm"], traffic["slope"]
    scale = traffic.get("texture_scale", (0.8, 1.25))
    return np.stack([rng.uniform(*z0, n), rng.uniform(-slope, slope, n), rng.uniform(*scale, n),
                     rng.uniform(0.0, 1000.0, n), rng.uniform(0.0, 1000.0, n)], axis=1)


def train_pool(seed: int, traffic: dict, setting: dict, device) -> list[dict]:
    """``traffic['pool']`` training batches of ``setting['batch']`` samples,
    every sample another scene: the reference camera at x = b and its two
    neighbours at 0 and 2 b (b the sample's baseline), the recipe's u8
    images, the feature-resolution projections, the setting's depth planes,
    the exact depth at feature resolution and a full mask. Numpy arrays on
    the host, as a loader hands them over."""
    rng = np.random.default_rng([seed, 1])
    B, V, (h, w), D = setting["batch"], setting["views"], setting["img_hw"], setting["numdepth"]
    n = traffic["pool"] * B
    scenes = _scene_rows(rng, n, traffic)
    baselines = rng.uniform(*traffic["baseline_mm"], n)
    order = [1, 2, 0][:V] if V <= 3 else [1, 2, 0] + list(range(3, V))
    E = np.concatenate([translation_extrinsics([baselines[i] * c for c in order]) for i in range(n)])
    K = np.tile(intrinsics(traffic["focal"], h, w), (n * V, 1, 1))
    imgs, depth = render(K, E, np.repeat(scenes, V, axis=0), h, w, device)
    imgs = imgs.reshape(n, V, h, w, 3).cpu().numpy()
    gt = depth.reshape(n, V, h, w)[:, 0, ::4, ::4].cpu().numpy()
    proj = feature_proj(K, E).reshape(n, V, 4, 4)
    planes = depth_hypotheses(setting["depth_min"], setting["depth_interval"] * setting["interval_scale"], D)
    return [{"imgs": imgs[i:i + B], "proj_matrices": proj[i:i + B], "depth_values": np.tile(planes, (B, 1)),
             "depth": gt[i:i + B], "mask": np.ones_like(gt[i:i + B])} for i in range(0, n, B)]


def request_pool(seed: int, traffic: dict, setting: dict, device) -> list[dict]:
    """``traffic['pool']`` requests of one reference view and its
    ``setting['views'] - 1`` nearest ring neighbours, each another scene
    and reference camera of the ring: u8 images [1, V, H, W, 3], projections
    [1, V, 4, 4], planes [1, D]; numpy on the host."""
    rng = np.random.default_rng([seed, 2])
    V, (h, w), D = setting["views"], setting["img_hw"], setting["numdepth"]
    n, ring = traffic["pool"], traffic["ring"]
    ring_E = ring_extrinsics(ring["cameras"], ring["radius_mm"], ring["height_mm"], ring["target_z_mm"])
    refs = rng.integers(0, ring["cameras"], n)
    offsets = [0, 1, -1, 2, -2, 3, -3][:V]
    E = np.concatenate([ring_E[[(r + o) % ring["cameras"] for o in offsets]] for r in refs])
    K = np.tile(intrinsics(ring["focal_over_width"] * w, h, w), (n * V, 1, 1))
    scenes = _scene_rows(rng, n, traffic)
    imgs, _ = render(K, E, np.repeat(scenes, V, axis=0), h, w, device)
    imgs = imgs.reshape(n, 1, V, h, w, 3).cpu().numpy()
    proj = feature_proj(K, E).reshape(n, 1, V, 4, 4)
    planes = depth_hypotheses(setting["depth_min"], setting["depth_interval"] * setting["interval_scale"], D)[None]
    return [{"imgs": imgs[i], "proj_matrices": proj[i], "depth_values": planes} for i in range(n)]


def write_cam(path: str, K: np.ndarray, E: np.ndarray, depth_min: float, interval: float) -> None:
    lines = ["extrinsic", *(" ".join(f"{x:.8f}" for x in row) for row in E), "", "intrinsic",
             *(" ".join(f"{x:.8f}" for x in row) for row in K), "", f"{depth_min:.6f} {interval:.6f}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_pairs(path: str, pairs: list[tuple[int, list[int]]]) -> None:
    with open(path, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref, srcs in pairs:
            f.write(f"{ref}\n{len(srcs)} " + " ".join(f"{v} 0" for v in srcs) + "\n")


def ring_pairs(n: int) -> list[tuple[int, list[int]]]:
    """Every other camera of an ``n`` ring, nearest first."""
    return [(ref, sorted((v for v in range(n) if v != ref), key=lambda v: (min((v - ref) % n, (ref - v) % n), v)))
            for ref in range(n)]


def write_scan_tree(root: str, seed: int, traffic: dict, setting: dict, device) -> dict:
    """The bin registry's tree: ``<root>/pair.txt``,
    ``<root>/acquisition/rig/Cameras/XXXXXXXX_cam.txt`` (full-resolution
    intrinsics; a depth line whose planes, at the setting's interval scale,
    cover every pool scene with a margin) and ``traffic['pool']`` scans of
    the ring under ``Rectified/pool<k>/00000XXX.png``. Returns the tree's
    paths, the cameras and the depth line."""
    from PIL import Image

    rng = np.random.default_rng([seed, 3])
    (h, w), D, ring = setting["img_hw"], setting["numdepth"], traffic["ring"]
    n_cams, n = ring["cameras"], traffic["pool"]
    E = ring_extrinsics(n_cams, ring["radius_mm"], ring["height_mm"], ring["target_z_mm"])
    K = intrinsics(ring["focal_over_width"] * w, h, w)
    scenes = _scene_rows(rng, n, traffic)
    imgs, depth = render(np.tile(K, (n * n_cams, 1, 1)), np.tile(E, (n, 1, 1)), np.repeat(scenes, n_cams, axis=0),
                         h, w, device)
    lo, hi = float(depth.min()), float(depth.max())
    margin = 0.15 * (hi - lo) + 1.0
    scale = setting["interval_scale"]
    interval = round((hi - lo + 2 * margin) / (D * scale), 6)
    depth_min = round(lo - margin, 6)
    while True:  # the depth line as written, read back as the loaders read it
        try:
            depth_hypotheses(depth_min, interval * scale, D)
            break
        except ValueError:
            interval = round(interval + 1e-6, 6)
    testpath = os.path.join(root, "acquisition", "rig")
    os.makedirs(os.path.join(testpath, "Cameras"), exist_ok=True)
    write_pairs(os.path.join(root, "pair.txt"), ring_pairs(n_cams))
    for v in range(n_cams):
        write_cam(os.path.join(testpath, "Cameras", f"{v:0>8}_cam.txt"), K, E[v], depth_min, interval)
    imgs = imgs.reshape(n, n_cams, h, w, 3).cpu().numpy()
    pool = []
    for k in range(n):
        d = os.path.join(testpath, "Rectified", f"pool{k}")
        os.makedirs(d, exist_ok=True)
        for v in range(n_cams):
            Image.fromarray(imgs[k, v]).save(os.path.join(d, f"00000{v:0>3}.png"), compress_level=1)
        pool.append(d)
    return {"root": root, "testpath": testpath, "pool": pool, "n_cams": n_cams, "K": K, "E": E,
            "depth_min": depth_min, "interval": interval}
