"""The readings that the R-MVSNet cell's correctness limits are set from,
taken on the card at the cell's own sizes.

    python3 mvsbench/rmvs_control.py --workload rmvs_dtu_request --seeds <n> ... --control-seeds <n> ...

- ``--seeds``: ``control.py``'s program readings (one short run of the cell
  per seed in this process), whose largest over the seeds is each limit's
  lower reading.
- ``--control-seeds``: the cell's kind's ``readings``
  (``kinds/rmvs_request.py::readings`` for R-MVSNet) on that seed's
  weights and first ``checked`` requests: the control (reading 1 by
  construction), the reference rounded to bf16 (a witness), the reference's
  faults (``reference/rmvsnet.py::FAULTS``) and how far the maps are from
  degenerate; the least of the control's and of the faults' that read above
  the program's spread is each limit's upper reading.

Each reading is one JSON line on stdout; the last line sums them up. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="rmvs_dtu_request")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    from mvsbench import control, run

    run.set_caches()
    import torch

    from mvsbench import core, manifest

    if not torch.cuda.is_available():
        print("rmvs_control: no CUDA device", file=sys.stderr)
        return 3
    if args.seeds:
        rc = control.main(["--workload", args.workload, "--seeds", *map(str, args.seeds), "--seconds",
                           str(args.seconds)])
        if rc:
            return rc
    device = torch.device("cuda", 0)
    workload = manifest.workload(args.workload)
    traffic = manifest.traffic(workload["traffic"])
    upper: dict[str, dict[str, float]] = {}
    for seed in args.control_seeds:
        ctx = core.Ctx(workload=workload, config=manifest.config(workload["config"]), traffic=traffic,
                       seed=seed % 2**63, seconds=args.seconds, trace=False, device=device,
                       work_dir=core.work_dir(CHECKOUT, workload["name"]), t_start=time.perf_counter())
        for name, numbers in manifest.kind(traffic["kind"]).readings(ctx).items():
            for k, v in numbers.items():
                upper.setdefault(name, {})[k] = min(upper.get(name, {}).get(k, float("inf")), v)
            print(json.dumps({"seed": seed, "reading": name, **numbers}), flush=True)
        torch.cuda.empty_cache()
    found = core.forbidden_modules()
    print(json.dumps({"workload": args.workload, "upper": upper, "forbidden_modules": found}))
    return 0 if not found else 4


if __name__ == "__main__":
    sys.exit(main())
