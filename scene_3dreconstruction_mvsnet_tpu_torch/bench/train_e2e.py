"""Training's wall clock end to end, through ``train_cli`` and the real
loader: the counterpart of ``scripts/bench_train_e2e.py``.

    python -m scene_3dreconstruction_mvsnet_tpu_torch.bench.train_e2e [--views 16] [--epochs 2]

Writes a synthetic scan in the DTU training layout (``data/synthetic.py::
make_dtu_tree``: 7 lights per view, quarter-resolution depth maps and
masks, 512x640 images), then runs ``train_cli`` in a process of its own
with the script's arguments (the recipe's batch 4, 3 views, 192 planes,
``--img_cache``) and, on the card, ``--dtype bfloat16``. Epoch 0 is cold
(the first launches, a cold image cache); the last epoch is the steady row.
Each epoch's ``epoch N train wall`` line is parsed. The device probe, run
in another process, is ``bench/train_step.py --batch <batch_size>
--sustained``: the step alone, so ``host_share`` = 1 - device / steady.

The script's ``--pallas_*`` and ``--flat_*`` flags are left out: they are
TPU switches the port's CLI refuses. Prints ``{"train_e2e": {...}}`` with
the script's keys; ``d2h_channel_setup_s`` is 0.0, there being no tunnel.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

from ..data.synthetic import SyntheticRig, make_dtu_tree, write_scan_list
from . import REPO, add_common_args, emit, platform_fields, resolve_device


def build_tree(root: str, n_views: int, hw: tuple[int, int], ndepths: int) -> SyntheticRig:
    rig = SyntheticRig(n_views=n_views, img_hw=hw, baseline=2.0, z0=500.0, slope_x=0.15, focal=0.8 * hw[1])
    make_dtu_tree(root, scan="scan1", rig=rig, ndepths=ndepths)
    write_scan_list(os.path.join(root, "train.txt"), ["scan1"])
    write_scan_list(os.path.join(root, "test.txt"), ["scan1"])
    return rig


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(p)
    p.add_argument("--views", type=int, default=16,
                   help="rig views; the loader makes one sample per (view, light) with all 7 lights, so an epoch "
                        "has 7 x views samples")
    p.add_argument("--batch_size", type=int, default=4, help="the DTU recipe's batch")
    p.add_argument("--epochs", type=int, default=2, help="epoch 0 cold, the last the steady row")
    p.add_argument("--keep", action="store_true", help="keep the work directory under --out")
    p.add_argument("--no_device_probe", action="store_true", help="skip the step-alone probe (host/device split)")
    p.add_argument("--hw", type=int, nargs=2, default=(512, 640), metavar=("H", "W"), help="image size (tests only)")
    p.add_argument("--numdepth", type=int, default=192, help="depth planes (tests only)")
    args = p.parse_args(argv)
    args.out = os.path.abspath(args.out)  # the children run in REPO
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    h, w = args.hw
    os.makedirs(args.out, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="train_e2e_", dir=args.out)
    root = os.path.join(workdir, "dtu")
    t0 = time.time()
    build_tree(root, args.views, (h, w), args.numdepth)
    t_fixture = time.time() - t0

    cmd = [
        sys.executable, "-m", "scene_3dreconstruction_mvsnet_tpu_torch.train_cli",
        "--mode", "train", "--dataset", "dtu_yao",
        "--trainpath", root, "--testpath", root,
        "--trainlist", os.path.join(root, "train.txt"), "--testlist", os.path.join(root, "test.txt"),
        "--epochs", str(args.epochs), "--batch_size", str(args.batch_size),
        "--numdepth", str(args.numdepth), "--interval_scale", "1.06",
        "--NtrainViews", "3", "--NtestViews", "3",
        "--lr", "0.001", "--lrepochs", "10,12,14:2",
        "--logdir", os.path.join(workdir, "log"),
        "--summary_freq", "100", "--save_freq", "100",  # no checkpoint inside the bench
        "--seed", "1", "--num_workers", "4",
        "--img_cache", os.path.join(workdir, "imgcache"),
        "--device", args.device,
    ] + (["--dtype", "bfloat16"] if on_card else [])
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600, cwd=REPO)
    proc_wall = time.time() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit("train_cli failed")

    epochs = re.findall(r"epoch (\d+) train wall: ([\d.]+)s \((\d+) samples, ([\d.]+) samples/s end-to-end\)",
                        proc.stdout)
    rows = {int(e): {"wall_s": float(t), "samples": int(n), "samples_per_s": float(s)} for e, t, n, s in epochs}
    if not rows:
        print(proc.stdout[-3000:], file=sys.stderr)
        raise SystemExit("no epoch wall lines found")
    steady = rows[max(rows)]
    res = {
        "config": f"DTU recipe bs{args.batch_size} 3v {h}x{w} D{args.numdepth} {'bf16' if on_card else 'f32 cpu'}",
        "epoch0_cold": rows.get(0),
        "steady_epoch": steady,
        "steady_s_per_step": steady["wall_s"] / max(1, steady["samples"] // args.batch_size),
        "proc_wall_s": proc_wall,
        "fixture_gen_s": t_fixture,
        "d2h_channel_setup_s": 0.0,
    }

    if not args.no_device_probe:
        probe = subprocess.run(
            [sys.executable, "-m", "scene_3dreconstruction_mvsnet_tpu_torch.bench.train_step",
             "--batch", str(args.batch_size), "--sustained", "--device", args.device, "--out", args.out,
             "--hw", str(h), str(w), "--numdepth", str(args.numdepth)],
            capture_output=True, text=True, timeout=1800, cwd=REPO,
        )
        m = re.search(r"sustained .*: ([\d.]+) s/step", probe.stdout)
        if probe.returncode != 0 or not m:
            print(probe.stdout[-1500:], probe.stderr[-1500:], file=sys.stderr)
            raise SystemExit("the device probe (bench.train_step --sustained) failed")
        res["device_s_per_step"] = float(m.group(1))
        res["host_share"] = 1 - res["device_s_per_step"] / res["steady_s_per_step"]
    res.update(platform_fields(device))
    if not args.keep:
        shutil.rmtree(workdir, ignore_errors=True)
    return emit(f"train_e2e_bs{args.batch_size}", {"train_e2e": res}, args.out)


if __name__ == "__main__":
    main()
