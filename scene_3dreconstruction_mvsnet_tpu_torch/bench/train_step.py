"""The train step alone at the DTU recipe's geometry: the counterpart of
``scripts/bench_train_step.py``.

    python -m scene_3dreconstruction_mvsnet_tpu_torch.bench.train_step [--batch N] [--remat] [--sustained]

3 views of the translation rig at 512x640, 192 planes, bf16 convs, Adam at
lr 1e-3, random weights and a random batch already on the device; the
port's ``make_train_step``, so on the card K1-emit, K3-terms and K3 run. It
excludes the input pipeline (``bench/train_e2e.py`` has it). ``--batch``
is 1 by default, as the script's, where the recipe trains at 4.

Per step, the host clock around each step with its loss read; with
``--sustained``, 5 steps queued per synchronize (each on the parameters
and optimizer state the previous one left), the best of 3 runs after a
first. Prints the script's lines (``train step sustained (...): X s/step``
keeps its shape: ``bench/train_e2e.py`` reads it) and one JSON line.

``--flat`` is accepted and does nothing: the flat layout is the same
arithmetic in a TPU's tiles. ``--xla`` and ``--no-paired`` choose TPU paths
the card does not have and are refused.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..models import MVSNet, random_init_
from ..train import make_optimizer, make_train_step
from . import add_common_args, emit, platform_fields, resolve_device, synchronize
from .headline import SEED
from .rigs import translation_rig

V, H, W, D = 3, 512, 640, 192
SUSTAINED_STEPS = 5

# flag -> why the port refuses it
REFUSED = {
    "--xla": "the XLA scatter-add backward is a TPU path; on the card the paired sweep (K1-emit, K3-terms, K3) "
             "always runs",
    "--no-paired": "the XLA sweep forward with a Pallas backward is a TPU path; on the card the paired sweep "
                   "always runs",
}


class _Refuse(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not supported by the PyTorch port: {REFUSED[option_string]}")


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(p)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--remat", action="store_true", help="recompute the sweep and CostRegNet in the backward")
    p.add_argument("--sustained", action="store_true", help=f"{SUSTAINED_STEPS} steps per synchronize, best of 3")
    p.add_argument("--flat", action="store_true", help="accepted; no effect (a TPU layout of the same arithmetic)")
    p.add_argument("--hw", type=int, nargs=2, default=(H, W), metavar=("H", "W"), help="image size (tests only)")
    p.add_argument("--numdepth", type=int, default=D, help="depth planes (tests only)")
    for flag in REFUSED:
        p.add_argument(flag, nargs=0, action=_Refuse, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    B, (h, w), d = args.batch, args.hw, args.numdepth

    rng = np.random.RandomState(0)
    K = np.array([[w * 0.7, 0, w / 8], [0, w * 0.7, h / 8], [0, 0, 1]], np.float32)
    batch = {
        "imgs": rng.rand(B, V, h, w, 3).astype(np.float32),
        "proj_matrices": np.broadcast_to(translation_rig(V, 2.0, K / 4.0)[None], (B, V, 4, 4)).copy(),
        "depth_values": np.broadcast_to(np.linspace(425, 905, d, dtype=np.float32)[None], (B, d)).copy(),
        "depth": rng.uniform(425, 905, (B, h // 4, w // 4)).astype(np.float32),
        "mask": np.ones((B, h // 4, w // 4), np.float32),
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    model = random_init_(MVSNet(dtype=torch.bfloat16, remat=args.remat), torch.Generator().manual_seed(SEED))
    model = model.to(device)
    opt = make_optimizer(model, 1e-3)
    step = make_train_step(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0), device)
    mode = f"remat={args.remat} flat={args.flat} B={B}"
    shape = f"{V}v {h}x{w} D{d} bf16"

    if args.sustained:
        def run() -> list[float]:
            losses = [step(batch)["loss"] for _ in range(SUSTAINED_STEPS)]
            synchronize(device)
            return [float(x) for x in losses]

        t0 = time.perf_counter()
        losses = run()
        first = time.perf_counter() - t0
        print(f"compile+first scan: {first:.1f}s losses={np.asarray(losses[:3])}")
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = min(best, (time.perf_counter() - t0) / SUSTAINED_STEPS)
        print(f"train step sustained ({mode}, {shape}): {best:.4f} s/step")
    else:
        t0 = time.perf_counter()
        losses = [float(step(batch)["loss"])]
        first = time.perf_counter() - t0
        print(f"compile+first step: {first:.1f}s loss={losses[0]:.3f}")
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            float(step(batch)["loss"])
        best = (time.perf_counter() - t0) / iters
        print(f"train step ({mode}, {shape}): {best:.4f} s/step (host clock, the loss read after each step)")
    result = {"mode": mode, "config": shape, "sustained": args.sustained, "first_s": first, "first_loss": losses[0],
              "s_per_step": best, **platform_fields(device)}
    return emit(f"train_step_b{B}{'_sustained' if args.sustained else ''}{'_remat' if args.remat else ''}",
                {"train_step": result}, args.out)


if __name__ == "__main__":
    main()
