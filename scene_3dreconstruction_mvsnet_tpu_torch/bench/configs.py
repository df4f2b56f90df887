"""The four rigs of ``scripts/bench_configs.py``, on the port.

    python -m scene_3dreconstruction_mvsnet_tpu_torch.bench.configs

  1. dtu_small  3 views, 512x640, 96 planes, translation rig;
  2. dtu_full   5 views, 864x1152, 192 planes, translation rig, and stage
                B's filter over 49 views with 10 sources each;
  3. bds8_ring  5 views of a 49-camera inward ring (the reference camera and
                its 4 nearest ring neighbours), 512x640, 192 planes, and the
                filter over the 49-camera ring, 10 sources each;
  4. bin_rig    4 cameras of an inward ring, 512x640, 192 planes, and the
                filter over the 4 cameras, 3 sources each.

The same rigs, intrinsics, depth values and result keys as the script. The
forward is timed as in ``headline.py`` (bf16, K1 and K2 on the card); the
JAX script's ``depth_chunk=48`` exists for a TPU's memory and is dropped.
The filter is ``eval/filtering.py::fuse_scan`` on the device over random
depth and confidence maps, ending in a synchronize: its seconds per
reference view. Prints one JSON line of every configuration's results.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..eval.filtering import fuse_scan
from . import add_common_args, emit, platform_fields, resolve_device, synchronize
from .headline import ITERS, WARMUP, build_model, sustained_seconds
from .rigs import ring_rig, translation_rig


def bench_forward(V: int, H: int, W: int, projs: np.ndarray, dv: np.ndarray, device: torch.device,
                  iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Sustained seconds per depth map of the bf16 forward on the V cameras
    of ``projs``."""
    imgs = torch.from_numpy(np.random.RandomState(0).rand(1, V, H, W, 3).astype(np.float32)).to(device)
    proj = torch.from_numpy(np.ascontiguousarray(projs[None])).to(device)
    return sustained_seconds(build_model(device), imgs, proj, torch.from_numpy(dv[None]).to(device), iters, warmup)


def bench_filter(n_views: int, H: int, W: int, extrinsics: np.ndarray, n_src: int, device: torch.device,
                 iters: int = 3) -> float:
    """Seconds per reference view of the whole-scan filter over ``n_views``
    random depth and confidence maps at feature resolution, ``n_src``
    sources each; one warm call, then the mean of ``iters``."""
    h4, w4 = H // 4, W // 4
    rng = np.random.RandomState(0)
    depths = rng.uniform(425, 905, (n_views, h4, w4)).astype(np.float32)
    confs = rng.rand(n_views, h4, w4).astype(np.float32)
    pair_data = [(r, [s for s in range(n_views) if s != r][:n_src]) for r in range(n_views)]
    K = np.array([[0.7 * w4, 0, w4 / 2], [0, 0.7 * w4, h4 / 2], [0, 0, 1]], np.float32)
    Ks = np.stack([K] * n_views)

    def run() -> None:
        fuse_scan(depths, confs, Ks, extrinsics[:n_views], pair_data, list(range(n_views)), NviewFilter=n_src,
                  photomask=0.5, geomask=2, device=device)
        synchronize(device)

    run()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return (time.perf_counter() - t0) / iters / n_views


def forward_rigs(hw: tuple[int, int] | None = None, numdepth: int | None = None) -> dict[str, tuple]:
    """Each configuration's forward, by result key: (V, H, W, D, the V
    cameras' projections [V, 4, 4] at feature resolution, the depth values
    [D]); ``hw`` and ``numdepth`` replace every configuration's size (the
    tests' small runs)."""

    def size(H, W, D):
        (H, W), D = hw or (H, W), numdepth or D
        return H, W, D, np.linspace(425, 905, D).astype(np.float32)

    def translation_K(H, W):
        return np.array([[W * 0.7, 0, W / 8], [0, W * 0.7, H / 8], [0, 0, 1]], np.float32) / 4.0

    rigs = {}
    H, W, D, dv = size(512, 640, 96)
    rigs["dtu_small_3v_96d_512x640"] = (3, H, W, D, translation_rig(3, 2.0, translation_K(H, W)), dv)
    H, W, D, dv = size(864, 1152, 192)
    rigs["dtu_full_5v_192d_864x1152"] = (5, H, W, D, translation_rig(5, 2.0, translation_K(H, W)), dv)
    # the BDS8 49-camera ring: a reference camera and its 4 nearest ring neighbours
    H, W, D, dv = size(512, 640, 192)
    K = np.array([[W * 1.1, 0, W / 2], [0, W * 1.1, H / 2], [0, 0, 1]], np.float32) / 4.0
    rigs["bds8_49cam_5v_192d_512x640"] = (5, H, W, D, ring_rig(49, 150.0, -700.0, 700.0, K)[[0, 1, 48, 2, 47]], dv)
    # the bin's 4-camera rig (the BDS8 intrinsics)
    rigs["bin_4cam_4v_192d_512x640"] = (4, H, W, D, ring_rig(4, 120.0, -650.0, 650.0, K), dv)
    return rigs


# stage B's filter: result key -> (saved views, the ring they sit on (n, radius, height, z0), sources each)
FILTERS = {
    "dtu_full_5v_192d_864x1152": (49, (49, 50.0, -600.0, 600.0), 10),  # DTU's NviewFilter
    "bds8_49cam_5v_192d_512x640": (49, (49, 150.0, -700.0, 700.0), 10),
    "bin_4cam_4v_192d_512x640": (4, (4, 120.0, -650.0, 650.0), 3),
}


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(p)
    p.add_argument("--hw", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="every configuration's image size (tests only)")
    p.add_argument("--numdepth", type=int, default=None, help="every configuration's planes (tests only)")
    p.add_argument("--iters", type=int, default=ITERS, help="forwards per synchronize (tests only)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    results = {}
    for name, (V, H, W, D, projs, dv) in forward_rigs(args.hw, args.numdepth).items():
        res = results[name] = {"sec_per_depthmap": bench_forward(V, H, W, projs, dv, device, args.iters),
                               "shape": f"{V}v {D}d {H}x{W}"}
        if name in FILTERS:
            n_views, ring, n_src = FILTERS[name]
            res["filter_sec_per_view"] = bench_filter(n_views, H, W, ring_rig(*ring, np.eye(3, dtype=np.float32)),
                                                      n_src, device)
    results.update(platform_fields(device))
    return emit("configs", results, args.out)


if __name__ == "__main__":
    main()
