"""The repository's measurement entry points, on the port.

Each module is the counterpart of one of the JAX package's bench scripts and
runs its configuration through the port's models, kernels and CLIs:

  ``headline``       ``bench.py``: depth maps per second at the inference
                     headline (also ``python -m
                     scene_3dreconstruction_mvsnet_tpu_torch.bench``);
  ``configs``        ``scripts/bench_configs.py``: four rigs' forwards and
                     stage B's filter per view;
  ``train_step``     ``scripts/bench_train_step.py``: the train step alone;
  ``train_e2e``      ``scripts/bench_train_e2e.py``: ``train_cli`` epochs
                     through the real loader;
  ``e2e_eval``       ``scripts/bench_e2e_eval.py``: ``eval_cli`` files in to
                     PLY out, and ``--serve``;
  ``profile_input``  ``scripts/profile_input.py``: stage A's host decode
                     against the forward.

Every entry point runs on ``cuda`` unless given ``--device cpu`` (the tests
do, at the sizes ``--hw``, ``--numdepth`` and ``--iters`` cut to), and fails
when it finds no card: there is no fallback to the CPU or to a kernel's
plain version. It prints its results as JSON, with the platform and, on a
card, the card's name and power limit, and writes them under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "outputs" / "bench_torch"


def add_common_args(parser: argparse.ArgumentParser) -> None:
    """``--device`` and ``--out``, shared by every entry point."""
    parser.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N, or cpu (the tests' small runs)")
    parser.add_argument("--out", default=str(DEFAULT_OUT), help="directory for the results' JSON files")


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; exits with a message when it names a card and
    there is none."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name} but torch.cuda.is_available() is False (no NVIDIA GPU or no CUDA build "
                         "of torch); the bench does not fall back to the CPU (--device cpu runs the small test sizes)")
    return device


def platform_fields(device: torch.device) -> dict:
    """``platform`` ("gpu" or "cpu"), ``backend`` and ``device``: the card's
    name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, None on the CPU."""
    if device.type != "cuda":
        return {"platform": "cpu", "backend": "torch", "device": None}
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return {"platform": "gpu", "backend": "torch", "device": lines[min(device.index or 0, len(lines) - 1)]}


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def emit(name: str, result: dict, out_dir: str) -> dict:
    """Print ``result`` as one JSON line and write it to
    ``<out_dir>/<name>.json``; returns it."""
    print(json.dumps(result), flush=True)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(result, indent=2) + "\n")
    return result
