"""Run one cell of the benchmark once.

    python3 mvsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on the machine that holds the NVIDIA card(s)
the cell asks for. Prints, as its last line on stdout, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``,
``breakdown`` (with ``--trace 1``) and last ``checks``, each number compared
with its limit; the same numbers are the last lines on stderr. Exits
non-zero, with no result, where there is no card or too few, where the port
cannot be imported, or where JAX or the JAX package was loaded.

Every cache the run or the program writes lies in the checkout:
the port's kernel builds in ``build/kernels/`` (fixed by the port), and
Triton's, the CUDA JIT's and torch's extension caches, which this sets, under
``build/mvsbench/cache/``. What a run writes goes under ``build/mvsbench/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions", "CUDA_CACHE_PATH": "cuda",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def set_caches(checkout: str = CHECKOUT) -> None:
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(checkout, "build", "mvsbench", "cache", sub)


def parse(argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def execute(workload: dict, seed: int, seconds: float, trace: bool, device, configs: dict | None = None,
            t_start: float = T_START):
    """Run a cell (``workload``, as ``manifest.workload`` reads it) on
    ``device`` -> (the kind's Outcome, the Ctx). ``configs`` may give the
    configuration and traffic instead of their files (the tests' small
    sizes)."""
    from mvsbench import core, manifest

    config = (configs or {}).get("config") or manifest.config(workload["config"])
    traffic = (configs or {}).get("traffic") or manifest.traffic(workload["traffic"])
    ctx = core.Ctx(workload=workload, config=config, traffic=traffic, seed=seed % 2**63, seconds=seconds,
                   trace=trace, device=device, work_dir=core.work_dir(CHECKOUT, workload["name"]), t_start=t_start)
    return manifest.kind(traffic["kind"]).run(ctx), ctx


def result_line(bench: dict, workload: dict, outcome, trace: bool, device_info: dict) -> dict:
    """The result's JSON object, ``checks`` last."""
    from mvsbench import manifest

    e2e, layers = manifest.cell_metrics(bench, workload["name"])
    metrics = {}
    if trace:
        record = {**outcome.record, "e2e": outcome.e2e}
        for m in layers:
            value = manifest.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]], "unit": m["unit"]} for m in e2e}
    device = {**device_info, "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": all(c.ok for c in outcome.checks) and bool(outcome.checks), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.trace:
        device["busy_s"], device["window_s"] = outcome.trace["busy_s"], outcome.trace["window_s"]
        line["breakdown"] = {"device_ops": [[k[:120], v] for k, v in outcome.trace["device_ops"]],
                             "idle_gaps": [[k[:120], v] for k, v in outcome.trace["idle_gaps"]]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    set_caches()
    import torch

    from mvsbench import core, manifest

    try:
        workload = manifest.workload(args.workload)
        bench = manifest.benchmark()
    except FileNotFoundError as e:
        print(f"mvsbench: {e}", file=sys.stderr)
        return 2
    chips = workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mvsbench: the cell {args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        __import__(core.PORT)
    except ImportError as e:
        print(f"mvsbench: the port {core.PORT} cannot be imported here: {e}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    limit = power_limit()
    if limit:
        info["name_power_limit"] = limit
    outcome, _ = execute(workload, args.seed, args.seconds, bool(args.trace), device)
    found = core.forbidden_modules()
    if found:
        print(f"mvsbench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    if args.trace and not (outcome.trace and outcome.trace["busy_s"] > 0):
        print("mvsbench: the profiler recorded no device activity in the window", file=sys.stderr)
        return 5
    line = result_line(bench, workload, outcome, bool(args.trace), info)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
