"""What a run of one cell carries from the harness to its traffic's kind and
back: the run's context, the numbers compared and the outcome."""

from __future__ import annotations

import math
import os
import statistics
import sys
from dataclasses import dataclass

import torch

PORT = "scene_3dreconstruction_mvsnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "scene_3dreconstruction_mvsnet_tpu")


@dataclass
class Ctx:
    """One run: the cell's workload, configuration and traffic files, its
    seed, window and trace flag, the device, the directory the run may write
    (inside the checkout) and the process's start on ``time.perf_counter``."""
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    work_dir: str
    t_start: float

    def log(self, msg: str) -> None:
        print(f"[mvsbench {self.workload['name']}] {msg}", file=sys.stderr, flush=True)


@dataclass
class Check:
    """A number compared with its limit (the check passes when value <= limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """A kind's run: the end-to-end metrics by name (``setup_s`` included),
    the record the per-layer readers read, the checks, the work attempted
    and failed in the window, the peak device memory, and with a trace the
    device's busy seconds, the traced window and the breakdown."""
    e2e: dict[str, float]
    record: dict
    checks: list[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict | None = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) of ``values``, Python's
    ``statistics.quantiles`` (exclusive method) for 100 cuts."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100)[int(q) - 1]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX package's, JAX's or
    flax's (compared whole: the port's own name begins with the JAX
    package's)."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def leaf_gap(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
             keep: list[str]) -> tuple[float, str, float]:
    """Each leaf's gap between the program's and the reference's norms, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger -> (the worst leaf's gap, that leaf, the median leaf's gap)."""
    ref_norms = {k: float(ref[k].double().norm()) for k in keep}
    median = statistics.median(ref_norms.values())
    gaps = {}
    for k in keep:
        gap = abs(float(prog[k].double().norm()) - ref_norms[k]) / max(ref_norms[k], median, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf, statistics.median(gaps.values())


def moving_leaves(ref_grads: dict[str, torch.Tensor], share: float = 1e-3) -> list[str]:
    """Leaves whose reference gradient norm is at least ``share`` of the
    median leaf's: the others (a bias under a softmax) move by round-off."""
    norms = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= share * median]


def work_dir(checkout: str, name: str) -> str:
    """A fixed directory of the run under the checkout's ``build/``."""
    path = os.path.join(checkout, "build", "mvsbench", name)
    os.makedirs(path, exist_ok=True)
    return path
