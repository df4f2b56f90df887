"""The readings that the correctness limits are set from, taken on the card
at a cell's own sizes.

    python3 mvsbench/control.py --workload <cell> --seeds <n> ... --control-seeds <n> ... [--seconds 3]

- For each of ``--seeds``: one run of the cell in this process (set-up, a
  short window at the cell's load, the comparison): the program's numbers,
  whose largest over the seeds is each limit's lower reading.
- For each of ``--control-seeds``: the control, the reference in the next
  precision below the configuration's (the workload file's ``control``)
  put in the program's place on that seed's weights and inputs, compared
  with the reference as the program is: the upper readings. A training cell
  also reads the fault "half of the batch left out, the mean over the rest"
  (the reference on each batch's first half); the fault "a step that returns
  its state unchanged" reads 1 on the gradient and the change by
  construction.

Each reading is one JSON line on stdout; the last line sums them up. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def train_control(ctx, control: str) -> dict[str, dict]:
    import torch

    from mvsbench import scenes
    from mvsbench.kinds.train import CHECKED_STEPS, depth_span, reference_steps, step_numbers
    from mvsbench.reference import mvsnet as ref_mvsnet
    from mvsbench.weights import make_state_dict

    s = ctx.config["train"]
    state = make_state_dict(ref_mvsnet.MVSNet().state_dict(), ctx.seed, ctx.device)
    batches = scenes.train_pool(ctx.seed, ctx.traffic, s, ctx.device)[:CHECKED_STEPS]  # the feed's first three
    want = reference_steps(state, batches, s["lr"], ctx.device)
    half = [{k: v[: len(v) // 2] for k, v in b.items()} for b in batches]
    out = {}
    for name, got in (("control_" + control, reference_steps(state, batches, s["lr"], ctx.device, control)),
                      ("bf16_rounding", reference_steps(state, batches, s["lr"], ctx.device, "bf16")),
                      ("fault_half_batch", reference_steps(state, half, s["lr"], ctx.device))):
        if name == "fault_half_batch":  # the half batch's depth maps beside the reference's of the same rows
            want_rows = (*want[:3], want[3][: got[3].shape[0]])
            out[name], worst = step_numbers(got, want_rows, depth_span(s))
        else:
            out[name], worst = step_numbers(got, want, depth_span(s))
        out[name]["worst"] = worst
    zero = {k: torch.zeros_like(v) for k, v in want[1].items()}
    out["fault_state_unchanged"], _ = step_numbers((want[0], zero, zero, want[3]), want, depth_span(s))
    return out


def request_control(ctx, control: str) -> dict[str, dict]:
    """The control, and beside it the reference rounded to bf16 (a witness
    of what the program's own precision alone gives), each over the
    control's error on the same answers."""
    from mvsbench import scenes
    from mvsbench.kinds.request import reference_answers, relative_errors
    from mvsbench.reference import mvsnet as ref_mvsnet
    from mvsbench.weights import make_state_dict

    s = ctx.config["eval"]
    state = make_state_dict(ref_mvsnet.MVSNet().state_dict(), ctx.seed, ctx.device)
    reqs = scenes.request_pool(ctx.seed, ctx.traffic, s, ctx.device)[: ctx.traffic["checked"]]
    want = reference_answers(state, reqs, s, ctx.device)
    got = reference_answers(state, reqs, s, ctx.device, control)
    witness = reference_answers(state, reqs, s, ctx.device, "bf16")
    return {"control_" + control: relative_errors(got, want, got, s),
            "bf16_rounding": relative_errors(witness, want, got, s)}


def scan_control(ctx, control: str) -> dict[str, dict]:
    """The control, and beside it the reference rounded to TF32 (a witness
    of what cuDNN's TF32 alone gives), on the first ``checked`` pool scans."""
    import shutil

    import torch

    from mvsbench import scenes
    from mvsbench.kinds.scan import depth_span, reference_maps, reference_scan, scan_errors, scan_weights, with_stage_b
    from mvsbench.reference import mvsnet as ref_mvsnet
    from mvsbench.reference.precision import exact

    s, filt = ctx.config["eval"], ctx.config["filter"]
    root = os.path.join(ctx.work_dir, "control_tree")
    shutil.rmtree(root, ignore_errors=True)
    tree = scenes.write_scan_tree(root, ctx.seed, ctx.traffic, s, ctx.device)
    scans = range(ctx.traffic["checked"])
    out = {}
    with exact(), torch.no_grad():
        model = ref_mvsnet.MVSNet().to(ctx.device).eval()
        model.load_state_dict(scan_weights(ctx.config, ctx.seed, ctx.device, tree))
        want = [reference_scan(model, tree, k, s, filt, ctx.device) for k in scans]
        ctl = [reference_maps(model, tree, k, s, ctx.device, control) for k in scans]
        for name, rnd in (("control_" + control, control), ("tf32_rounding", "tf32")):
            maps = ctl if rnd == control else [reference_maps(model, tree, k, s, ctx.device, rnd) for k in scans]
            got = [with_stage_b(m, tree, w, filt, ctx.device, rnd) for m, w in zip(maps, want)]
            out[name] = scan_errors(got, want, depth_span(tree, s), ctl)
    return out


CONTROLS = {"train": train_control, "request": request_control, "scan": scan_control}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--program-exact", action="store_true",
                   help="run the program's readings with TF32 off (a witness)")
    p.add_argument("--program-dtype", default=None,
                   help="run the program's readings in this dtype instead of the configuration's (a witness)")
    args = p.parse_args(argv)

    from mvsbench import run

    run.set_caches()
    import torch

    from mvsbench import core, manifest
    from mvsbench.reference.precision import exact

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    workload = manifest.workload(args.workload)
    lower: dict[str, float] = {}
    upper: dict[str, dict[str, float]] = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        configs = None
        if args.program_dtype:
            config = manifest.config(workload["config"])
            for section in ("train", "eval"):
                if section in config:
                    config[section]["dtype"] = args.program_dtype
            configs = {"config": config}
        with exact() if args.program_exact else contextlib.nullcontext():
            outcome, _ = run.execute(workload, seed, args.seconds, False, device, configs, t_start=t0)
        numbers = {k: v for k, v in outcome.record["numbers"].items() if isinstance(v, float)}
        for k, v in numbers.items():
            lower[k] = max(lower.get(k, 0.0), v)
        print(json.dumps({"seed": seed, "reading": "program", **numbers}), flush=True)
        del outcome
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        traffic = manifest.traffic(workload["traffic"])
        ctx = core.Ctx(workload=workload, config=manifest.config(workload["config"]), traffic=traffic,
                       seed=seed % 2**63, seconds=args.seconds, trace=False, device=device,
                       work_dir=core.work_dir(CHECKOUT, workload["name"]), t_start=time.perf_counter())
        for name, numbers in CONTROLS[traffic["kind"]](ctx, workload["control"]).items():
            for k, v in numbers.items():
                if isinstance(v, float):
                    upper.setdefault(name, {})[k] = min(upper.get(name, {}).get(k, float("inf")), v)
            print(json.dumps({"seed": seed, "reading": name, **numbers}), flush=True)
        torch.cuda.empty_cache()
    found = core.forbidden_modules()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper, "forbidden_modules": found}))
    return 0 if not found else 4


if __name__ == "__main__":
    sys.exit(main())
