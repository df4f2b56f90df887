"""Depth generation, filtering and fusion CLI of the PyTorch port.

    python -m scene_3dreconstruction_mvsnet_tpu_torch.eval_cli \\
        --dataset dataloader_eval --dataset_name dtu --testpath <acquisition> \\
        --testlist <scans.txt> --loadckpt model_000015.ckpt --outdir ./outputs \\
        --NviewGen 5 --numdepth 192 --NviewFilter 10 --dtype bfloat16 \\
        --pallas_conv0 --save_ply --device cuda

Counterpart of the repository's ``eval.py`` with its flags and behaviour:
the per-dataset registries, stage A (depth maps, ``eval/depth_gen.py``),
stage B (consistency filter and PLY fusion, ``eval/fusion.py``) run for each
scan on one worker thread as soon as stage A has written it, and ``--serve``,
which reads scan names from stdin and runs both stages per request in one
process (stage B synchronously). ``--loadckpt`` takes the reference's
``.ckpt`` files (``train/checkpoint.py``). ``--pallas_conv0`` keeps
``eval.py``'s name and meaning: CostRegNet's conv0 through the fused kernel
K4 (bf16 only). ``--data_shards N`` splits stage A's batches over N cards
(``--batch_size`` a multiple of N) and ``--img_cache`` reads the images
through the decoded-image cache. Flags that exist only for the TPU are
refused rather than ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from .eval.depth_gen import save_depth
from .eval.fusion import filter_depth
from .models import MVSNet, require_model
from .parallel import local_devices
from .train.checkpoint import load_model
from .utils import print_args

# flag -> why the port refuses it
REFUSED = {
    "--use_pallas": "a TPU kernel switch; on the card the regression kernel K2 always runs",
    "--pallas_sweep": "a TPU kernel switch; on the card the sweep kernel K1 always runs",
    "--flat_features": "the flat block-Toeplitz layout exists for the TPU's tiles",
    "--flat_costreg": "the flat block-Toeplitz layout exists for the TPU's tiles",
    "--aot_cache": "the compiled-executable cache exists for XLA on the TPU",
    "--no_device_store": "the device image store exists for the TPU's host link and is not ported",
}

# per-dataset registries (eval.py's, from the reference's eval.py)
DICT_CAM_SUBFOLDER = {
    "dtu": "Cameras", "bds1": "Cameras_1200x1600", "bds2": "Cameras_512x640", "bds4": "Cameras_512x640",
    "bds6": "Cameras_512x640", "bds7": "Cameras_512x640", "bds8": "Cameras_512x640", "bin": "Cameras",
}
DICT_IMG_SUBFOLDER = {
    "dtu": "Rectified_raw/{}/rect_{:0>3}_3_r5000.png",
    "bds1": "Rectified_1200x1600/{}/rect_C{:0>3}_L00.png",
    "bds2": "Rectified_512x640/{}/rect_C{:0>3}_L00.png",
    "bds4": "Rectified_1024x1280/{}/rect_C{:0>3}_L00.png",
    "bds6": "Rectified_512x640/{}/rect_C{:0>3}_L00.png",
    "bds7": "Rectified_512x640/{}/rect_C{:0>3}_L00.png",
    "bds8": "Rectified_512x640/{}/rect_C{:0>3}_L00.png",
    "bin": "Rectified/{}/00000{:0>3}.png",
}
DICT_IMG_RES = {
    "dtu": (600, 800), "bds1": (1200, 1600), "bds2": (512, 640), "bds4": (1024, 1280),
    "bds6": (1024, 1280), "bds7": (512, 640), "bds8": (512, 640), "bin": (512, 640),
}


class _Refuse(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not supported by the PyTorch port: {REFUSED[option_string]}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Predict depth, filter, and fuse (MVSNet, PyTorch/CUDA port)")
    p.add_argument("--model", default="mvsnet", help="select model (models.require_model; MVSNet is the one with "
                   "an eval path)")
    p.add_argument("--dataset", default="dataloader_eval", choices=["dtu_yao_eval", "blender_eval", "dataloader_eval"])
    p.add_argument("--dataset_name", default="dtu", choices=list(DICT_IMG_RES))
    p.add_argument("--testpath", help="testing data path")
    p.add_argument("--testlist", help="testing scan list")
    p.add_argument("--pairfile", default="pair.txt")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--loadckpt", default=None, help="checkpoint: a reference-format .ckpt file")
    p.add_argument("--outdir", default="./outputs")
    p.add_argument("--save_ply", action="store_true")
    p.add_argument("--postprocess", action="store_true",
                   help="crop to the bin's box, remove statistical outliers and voxel-downsample the fused cloud")
    p.add_argument("--NviewGen", type=int, default=5, help="number of views used to generate depth maps (DTU=5)")
    p.add_argument("--NviewFilter", type=int, default=10, help="number of src views used while filtering (DTU=10)")
    p.add_argument("--photomask", type=float, default=0.8, help="photometric confidence threshold")
    p.add_argument("--geomask", type=int, default=3, help="min number of consistent views")
    p.add_argument("--condmask_pixel", type=float, default=1.0, help="max reprojection distance in pixels")
    p.add_argument("--condmask_depth", type=float, default=0.01, help="max relative depth difference")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--depth_chunk", type=int, default=None, help="plane-sweep depth chunk size of the plain path (CPU)")
    p.add_argument("--pallas_conv0", action="store_true",
                   help="CostRegNet conv0 + BN + ReLU through the fused kernel K4 (requires --dtype bfloat16)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--data_shards", type=int, default=1,
                   help="split stage A's view/batch axis over this many cards (--batch_size must be a multiple)")
    p.add_argument("--img_cache", default=None,
                   help="directory for a cache of decoded, rescaled and cropped images, shared with the JAX "
                        "package's (repeat runs skip the PNG decode and the resize); the JAX package's "
                        "<img_cache>/aot executable cache is not used")
    p.add_argument("--no_overlap_filter", action="store_true",
                   help="run stage B strictly after stage A instead of filtering each scan as its depth maps finish")
    p.add_argument("--serve", action="store_true",
                   help="serving loop: read scan names from stdin (one per line; EOF or 'quit' ends) and run "
                        "stage A + B per request in this one process (--testlist is ignored)")
    p.add_argument("--skip_gen", action="store_true", help="skip stage A (reuse existing depth maps)")
    p.add_argument("--skip_filter", action="store_true", help="skip stage B")
    p.add_argument("--xy_scale", type=float, default=1.0531,
                   help="empirical world-x/y scale applied during fusion (the reference's)")
    p.add_argument("--debug_MVSnet", type=int, default=0, help="bitmask: dump forward stages as PNGs")
    p.add_argument("--debug_depth_gen", type=int, default=0,
                   help="bitmask: 0 input image, 1 depth/confidence PNGs, 2 per-view cloud PLY, 3 combined cloud PLY")
    p.add_argument("--debug_depth_filter", type=int, default=0,
                   help="bitmask: 0 depth+mask PNGs, 1 per-view cloud PLY, 2 fused cloud PLY")
    p.add_argument("--img_res", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="override registry image resolution")
    p.add_argument("--cam_subfolder", default=None, help="override registry camera subfolder")
    p.add_argument("--img_subfolder", default=None, help="override registry image filename template")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    for flag in REFUSED:
        p.add_argument(flag, nargs="?", action=_Refuse, help=argparse.SUPPRESS)
    return p


def load_weights(path: str | None, model: MVSNet) -> None:
    """Load a reference-format ``.ckpt`` into ``model`` (strict)."""
    if path is None:
        raise SystemExit("--loadckpt is required")
    if os.path.isdir(path):
        raise SystemExit(
            f"--loadckpt {path} is a directory (an orbax checkpoint of the JAX package); the port reads "
            "reference-format .ckpt files: convert the JAX variables with "
            "scene_3dreconstruction_mvsnet_tpu.interop.export_torch_state_dict and torch.save({'model': ...})"
        )
    load_model(path, model)


def serve_loop(args, model, gen_kwargs, run_filter) -> dict:
    """One long-lived process: scan names in on stdin, depth maps, masks and
    the PLY out, stage B synchronously after stage A of each request. The
    weights stay on the device across requests. Prints the throughput summary
    and returns it."""
    load_weights(args.loadckpt, model)
    served, views_total, views_after_first, t_first_done = 0, 0, 0, None
    print("SERVE ready: one scan name per line on stdin ('quit' ends)", flush=True)
    t_loop0 = time.time()
    for line in sys.stdin:
        scan = line.strip()
        if not scan or scan == "quit":
            break
        t0 = time.time()
        fd, tmplist = tempfile.mkstemp(suffix=".txt", text=True)
        with os.fdopen(fd, "w") as f:
            f.write(scan + "\n")
        try:
            stats = save_depth(model, testlist=tmplist, **gen_kwargs)
        finally:
            os.unlink(tmplist)
        if not args.skip_filter:
            run_filter(scan)
        dt = time.time() - t0
        served += 1
        views_total += stats["n_views"]
        if t_first_done is None:
            t_first_done = time.time()
        else:
            views_after_first += stats["n_views"]
        print(f"SERVED {scan}: {stats['n_views']} views in {dt:.2f}s ({stats['n_views'] / dt:.3f} views/s this request)",
              flush=True)
    total = time.time() - t_loop0
    summary = {"scans": served, "views": views_total, "wall_s": round(total, 2),
               "views_per_s": round(views_total / total, 3) if total > 0 else None}
    if t_first_done is not None and served > 1:
        summary["views_per_s_sustained"] = round(views_after_first / (time.time() - t_first_done), 3)
    print("SERVE summary: " + json.dumps(summary), flush=True)
    return summary


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns what it measured (stage A's stats and walls, or
    the serve summary)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    print("argv:", sys.argv[1:] if argv is None else argv)
    print_args(args)
    model_def = require_model(args.model, "eval")
    if args.pallas_conv0 and args.dtype != "bfloat16":
        parser.error("--pallas_conv0 requires --dtype bfloat16")
    if args.testpath is None:
        parser.error("--testpath is required")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"eval_cli: --device {args.device} but torch.cuda.is_available() is False "
            "(no NVIDIA GPU or no CUDA build of torch); pass --device cpu to run the plain path"
        )
    if args.data_shards > 1:
        try:
            local_devices(args.data_shards, device)
        except ValueError as e:
            parser.error(f"--data_shards {args.data_shards}: {e}")
        if args.batch_size % args.data_shards:
            parser.error(f"--batch_size {args.batch_size} must be a multiple of --data_shards {args.data_shards}")

    model = model_def(depth_chunk=args.depth_chunk, dtype=torch.bfloat16 if args.dtype == "bfloat16" else None,
                   fused_conv0=args.pallas_conv0)
    acquisition_folder = args.testpath.rstrip("/").split("/")[-1]
    outdir_acq = os.path.join(args.outdir, acquisition_folder)
    gen_kwargs = dict(
        dataset=args.dataset, dataset_name=args.dataset_name, testpath=args.testpath, outdir=args.outdir,
        NviewGen=args.NviewGen, numdepth=args.numdepth, interval_scale=args.interval_scale,
        pairfile=args.pairfile,
        cam_subfolder=args.cam_subfolder or DICT_CAM_SUBFOLDER[args.dataset_name],
        img_subfolder=args.img_subfolder or DICT_IMG_SUBFOLDER[args.dataset_name],
        img_res=tuple(args.img_res) if args.img_res else DICT_IMG_RES[args.dataset_name],
        num_workers=args.num_workers, debug_bitmask=args.debug_MVSnet, debug_depth_gen=args.debug_depth_gen,
        batch_size=args.batch_size, data_shards=args.data_shards, img_cache=args.img_cache, device=device,
    )

    filter_stats: list[dict] = []  # each scan's stage B, wherever it ran

    def run_filter(scan: str) -> None:
        t0 = time.time()
        found = re.findall(r"\d+", scan)
        scan_id = int(found[0]) if found else 0
        stats = filter_depth(
            args.testpath, scan, os.path.join(outdir_acq, scan),
            os.path.join(outdir_acq, f"mvsnet{scan_id:0>3}_l3.ply"),
            outdir_acq=outdir_acq, pairfile=args.pairfile, dataset_name=args.dataset_name,
            NviewFilter=args.NviewFilter, photomask=args.photomask, geomask=args.geomask,
            condmask_pixel=args.condmask_pixel, condmask_depth=args.condmask_depth, save_ply=args.save_ply,
            xy_scale=args.xy_scale, postprocess=args.postprocess, debug_depth_filter=args.debug_depth_filter,
            device=device,
        )
        filter_stats.append({"wall_s": time.time() - t0, **{k: stats[k] for k in ("load_s", "filter_s", "emit_s")}})

    if args.serve:
        return {"serve": serve_loop(args, model, gen_kwargs, run_filter), "stage_b": filter_stats}
    if args.testlist is None:
        parser.error("--testlist is required")

    # stage B of each finished scan on one worker (scan order) while stage A
    # generates the later scans
    overlap = not args.skip_gen and not args.skip_filter and not args.no_overlap_filter
    filter_pool = ThreadPoolExecutor(max_workers=1) if overlap else None
    filter_futures: dict = {}

    def on_scan_done(scan: str) -> None:
        filter_futures[scan] = filter_pool.submit(run_filter, scan)

    out: dict = {"stage_b": filter_stats}
    t_start = time.time()
    if not args.skip_gen:
        load_weights(args.loadckpt, model)
        print(f"ckpt load: {time.time() - t_start:.2f}s")
        out["stage_a"] = save_depth(model, testlist=args.testlist, on_scan_done=on_scan_done if overlap else None,
                                    **gen_kwargs)
        out["stage_a_wall"] = time.time() - t_start
        print(f"stage A wall: {out['stage_a_wall']:.3f}s (files in -> depth/conf PFMs out)")
    if args.skip_filter:
        return out

    t_b0 = time.time()
    with open(args.testlist) as f:
        scans = [line.rstrip() for line in f if line.strip()]
    for scan in scans:
        if scan in filter_futures:
            filter_futures[scan].result()  # overlapped with stage A
        else:
            run_filter(scan)
    if filter_pool is not None:
        filter_pool.shutdown()
    out["stage_b_wall"] = time.time() - t_b0
    print(f"stage B wall: {out['stage_b_wall']:.3f}s (PFMs in -> masks{' + PLY' if args.save_ply else ''} out)")
    print(f"total wall: {time.time() - t_start:.3f}s")
    return out


if __name__ == "__main__":
    main()
