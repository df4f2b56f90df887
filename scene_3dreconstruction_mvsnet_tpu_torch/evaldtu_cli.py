"""Legacy DTU evaluation CLI of the PyTorch port.

    python -m scene_3dreconstruction_mvsnet_tpu_torch.evaldtu_cli \\
        --testpath <DTU root> --testlist lists/dtu/test.txt \\
        --loadckpt model_000015.ckpt --outdir ./outputs --device cuda

Counterpart of the repository's ``evalDTU.py``, the older, DTU-only variant
of the two-stage pipeline, with its flags and defaults and the differences
it keeps from ``eval.py`` for compatibility with historical runs:

  - stage A (``save_depth``) runs MVSNet in f32 on the ``dtu_yao_eval``
    dataset (1200x1600 images cropped to 1184x1600), batch 1, and writes
    only the depth and confidence PFMs;
  - stage B (``filter_depth``) reads the cameras from the dataset's
    ``Cameras/`` folder and divides the intrinsics by 4 as it reads them,
    takes the colours from the raw image subsampled [0::4, 0::4] and
    cropped to the depth size, back-projects on the integer-corner pixel
    grid with no 1.0531 x/y scale (in numpy, as ``evalDTU.py`` does), and
    always writes a PLY.

The consistency filter runs on ``--device`` (``eval/filtering.py::
fuse_reference_view``). ``--debug_MVSnet`` and ``--debug_depth_gen`` are
parsed and unused, as in ``evalDTU.py``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

import numpy as np
import torch

from .data import Loader, find_dataset_def, prefetch_to_device
from .eval.depth_gen import auto_depth_chunk
from .eval.filtering import fuse_reference_view
from .eval_cli import load_weights
from .infer import make_infer_step
from .io import read_camera_parameters, read_img, read_pair_file, read_pfm, save_mask, save_pfm, write_ply
from .models import MVSNet, require_model
from .utils import print_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Legacy DTU depth fusion (MVSNet, PyTorch/CUDA port)")
    p.add_argument("--model", default="mvsnet", help="select model (models.require_model; MVSNet is the one with "
                   "an eval path)")
    p.add_argument("--dataset", default="dtu_yao_eval", choices=["dtu_yao_eval", "blender_eval"])
    p.add_argument("--testpath", help="testing data path")
    p.add_argument("--testlist", help="testing scan list")
    p.add_argument("--pairfile", default="pair.txt")
    p.add_argument("--batch_size", type=int, default=1, help="parsed, as evalDTU.py; stage A runs batch 1")
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--loadckpt", default=None, help="checkpoint: a reference-format .ckpt file")
    p.add_argument("--outdir", default="./outputs")
    p.add_argument("--NviewGen", type=int, default=5)
    p.add_argument("--NviewFilter", type=int, default=10)
    p.add_argument("--photomask", type=float, default=0.8)
    p.add_argument("--geomask", type=int, default=3)
    p.add_argument("--condmask_pixel", type=float, default=1.0)
    p.add_argument("--condmask_depth", type=float, default=0.01)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--skip_gen", action="store_true")
    p.add_argument("--debug_MVSnet", type=int, default=0, help="parsed and unused, as in evalDTU.py")
    p.add_argument("--debug_depth_gen", type=int, default=0, help="parsed and unused, as in evalDTU.py")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    return p


def save_depth(args, model: MVSNet) -> dict:
    """Stage A: a depth and a confidence PFM for every reference view, under
    ``<outdir>/<acquisition>/<scan>/{depth_est,confidence}/``. Returns each
    view's seconds (from the previous view's results to this one's), the
    host seconds of each phase over all views (``loader_wait`` for the next
    sample, ``launch`` queueing the forward, ``device_wait`` for its results,
    ``write`` of the PFMs) and, on a card, each forward's device span in ms
    from CUDA events."""
    device = torch.device(args.device)
    dataset = find_dataset_def(args.dataset)(
        datapath=args.testpath, listfile=args.testlist, mode="test", nviews=args.NviewGen, ndepths=args.numdepth,
        interval_scale=args.interval_scale, pairfile=args.pairfile,
    )
    loader = Loader(dataset, batch_size=1, num_workers=args.num_workers)
    infer = make_infer_step(model, device)
    acq = args.testpath.rstrip("/").split("/")[-1]
    seconds: list[float] = []
    device_ms: list[float] = []
    phases = dict.fromkeys(("loader_wait", "launch", "device_wait", "write"), 0.0)
    last = t_phase = time.time()

    def mark(phase: str) -> float:
        nonlocal t_phase
        now = time.time()
        phases[phase] += now - t_phase
        t_phase = now
        return now

    # samples are decoded, stacked and staged in pinned memory on a producer
    # thread, and copied to the card a view ahead, while the device runs the
    # previous view (packing them to u8 there, as the Trainer does, made the
    # producer the bottleneck at 1200x1600)
    for batch_idx, (sample, on_device) in enumerate(prefetch_to_device(loader, device)):
        mark("loader_wait")
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if device.type == "cuda" else None
        if events:
            events[0].record()
        outputs = infer(*(on_device[k] for k in ("imgs", "proj_matrices", "depth_values")))
        if events:
            events[1].record()
        mark("launch")
        depth = outputs["depth"][0].cpu().numpy()  # waits for the device
        conf = outputs["photometric_confidence"][0].cpu().numpy()
        now = mark("device_wait")
        seconds.append(now - last)
        last = now
        if events:
            device_ms.append(events[0].elapsed_time(events[1]))
        print(f"Iter {batch_idx}/{len(loader)}")
        filename = sample["filename"][0]
        depth_fn = os.path.join(args.outdir, acq, filename.format("depth_est", ".pfm"))
        conf_fn = os.path.join(args.outdir, acq, filename.format("confidence", ".pfm"))
        os.makedirs(os.path.dirname(depth_fn), exist_ok=True)
        os.makedirs(os.path.dirname(conf_fn), exist_ok=True)
        save_pfm(depth_fn, depth.astype(np.float32))
        save_pfm(conf_fn, conf.astype(np.float32))
        print(f"PFM saved: {depth_fn}")
        mark("write")
    print("stage A phases (s): " + " ".join(f"{k}={v:.2f}" for k, v in phases.items()))
    return {"n_views": len(seconds), "seconds": seconds, "phases": phases, "device_ms": device_ms}


def filter_depth(args, dataset_folder: str, scan: str, out_folder: str, plyfilename: str) -> dict:
    """Stage B of one scan: each reference view's photometric and geometric
    masks (``fuse_reference_view`` on ``args.device``), its consistent
    pixels back-projected, and all of them written to ``plyfilename``.
    Returns the scan's wall seconds and point count."""
    print("===== FILTER DEPTHs =====")
    t_scan = time.time()
    pair_data = read_pair_file(os.path.join(dataset_folder, "Cameras", args.pairfile))

    def cam(view):
        K, E = read_camera_parameters(os.path.join(dataset_folder, f"Cameras/{view:0>8}_cam.txt"))
        K[:2, :] /= 4.0  # the feature net's factor, applied as the cams are read
        return K, E

    vertices, vertex_colors = [], []
    for ref_view, src_views in pair_data:
        t0 = time.time()
        src_views = src_views[: args.NviewFilter]
        ref_K, ref_E = cam(ref_view)
        ref_depth = read_pfm(os.path.join(out_folder, f"depth_est/{ref_view:0>8}.pfm"))[0]
        confidence = read_pfm(os.path.join(out_folder, f"confidence/{ref_view:0>8}.pfm"))[0]
        ref_img = read_img(os.path.join(dataset_folder, f"Rectified_raw/{scan}/rect_{ref_view + 1:0>3}_3_r5000.png"))
        h_d, w_d = ref_depth.shape
        ref_img_cropped = ref_img[0::4, 0::4, :][:h_d, :w_d, :]

        src_cams = [cam(v) for v in src_views]
        src_depths = [read_pfm(os.path.join(out_folder, f"depth_est/{v:0>8}.pfm"))[0] for v in src_views]
        result = fuse_reference_view(
            ref_depth, confidence, ref_K, ref_E,
            np.stack(src_depths), np.stack([K for K, _ in src_cams]), np.stack([E for _, E in src_cams]),
            photomask=args.photomask, geomask=args.geomask, condmask_pixel=args.condmask_pixel,
            condmask_depth=args.condmask_depth, device=args.device,
        )
        photo_mask, geo_mask, final_mask = result["photo_mask"], result["geo_mask"], result["final_mask"]
        os.makedirs(os.path.join(out_folder, "mask"), exist_ok=True)
        save_mask(os.path.join(out_folder, f"mask/{ref_view:0>8}_photo.png"), photo_mask)
        save_mask(os.path.join(out_folder, f"mask/{ref_view:0>8}_geo.png"), geo_mask)
        save_mask(os.path.join(out_folder, f"mask/{ref_view:0>8}_final.png"), final_mask)
        print("SUMMARY: Ref_view: {:0>2}, photo/geo/final-mask:{:.2f}%/{:.2f}%/{:.2f}% time={:.2f}s".format(
            ref_view, photo_mask.mean() * 100, geo_mask.mean() * 100, final_mask.mean() * 100, time.time() - t0))

        # the legacy back-projection: integer grid, masked points, no 1.0531
        depth_avg = result["depth_est_averaged"]
        x, y = np.meshgrid(np.arange(w_d), np.arange(h_d))
        xv, yv, dv = x[final_mask], y[final_mask], depth_avg[final_mask]
        xyz_ref = np.linalg.inv(ref_K) @ (np.vstack([xv, yv, np.ones_like(xv)]) * dv)
        xyz_world = (np.linalg.inv(ref_E) @ np.vstack([xyz_ref, np.ones_like(xv)]))[:3]
        vertices.append(xyz_world.T)
        vertex_colors.append((ref_img_cropped[final_mask] * 255).astype(np.uint8))

    vertices_all = np.concatenate(vertices, axis=0)
    write_ply(plyfilename, vertices_all.astype(np.float32), np.concatenate(vertex_colors, axis=0))
    print("saving the final model to", plyfilename)
    return {"wall_s": time.time() - t_scan, "points": int(vertices_all.shape[0])}


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns stage A's per-view seconds and device spans, and
    each scan's stage B wall and point count."""
    args = build_parser().parse_args(argv)
    print("argv:", sys.argv[1:] if argv is None else argv)
    print_args(args)
    model_def = require_model(args.model, "eval")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"evaldtu_cli: --device {args.device} but torch.cuda.is_available() is False "
            "(no NVIDIA GPU or no CUDA build of torch); pass --device cpu to run the plain path"
        )

    # the plain sweep's depth chunk at the legacy resolution bounds its memory
    # on the CPU (the sweep kernel ignores it)
    model = model_def(depth_chunk=auto_depth_chunk((1200, 1600), args.numdepth))
    out: dict = {}
    t0 = time.time()
    if not args.skip_gen:
        load_weights(args.loadckpt, model)
        out["stage_a"] = save_depth(args, model)
        out["stage_a_wall"] = time.time() - t0
        print(f"stage A wall: {out['stage_a_wall']:.3f}s (images in -> depth/conf PFMs out)")

    with open(args.testlist) as f:
        scans = [line.rstrip() for line in f.readlines() if line.strip()]
    acq = args.testpath.rstrip("/").split("/")[-1]
    out["stage_b"] = []
    for scan in scans:
        scan_id = int(re.findall(r"\d+", scan)[0])
        out_folder = os.path.join(args.outdir, acq, scan)
        plyfilename = os.path.join(args.outdir, acq, f"mvsnet{scan_id:0>3}_l3.ply")
        out["stage_b"].append(filter_depth(args, args.testpath, scan, out_folder, plyfilename))
    return out


if __name__ == "__main__":
    main()
