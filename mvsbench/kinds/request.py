"""Request traffic: one client in a closed loop on the serving entry.

Set-up builds ``infer.py::make_infer_step`` around the port's MVSNet in the
configuration's eval dtype, with weights from the seed, and a pool of
distinct requests made from the seed (u8 images of a reference view and its
ring neighbours, their projections and the depth planes, on the host). A
request hands the host arrays to the entry and ends when depth and
confidence are on the host; the next is sent then. Requests cycle over the
pool. Warm-up serves ``warm`` requests of the pool's one shape.
``depthmaps_per_s`` is the depth maps delivered over the window (the window
ends when the last request has); ``request_p95_s`` the 95th percentile of
every request's latency in the window.

Correctness: a sample of the window's requests, drawn from the seed, is
answered again by the plain f32 reference from the same weights and
inputs, and by the reference in the precision below the configuration's
(the cell's ``control``). Compared: the mean absolute depth error (over the
depth range) and the mean absolute confidence error, each over the
control's own error on the same answers. How far rounding moves these
random weights' answers differs from seed to seed by more than the
precisions differ; the control's error on the seed's own answers is the
scale that moves with it, and the control reads 1 by construction.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import roofline, scenes
from ..core import Check, Ctx, Outcome, percentile, sync
from ..reference import mvsnet as ref_mvsnet
from ..reference.precision import exact, rounding
from ..timing import DeviceTrace, StageEvents
from ..weights import make_state_dict
from .train import dtype_of


def run(ctx: Ctx) -> Outcome:
    from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet

    s, tr, dev = ctx.config["eval"], ctx.traffic, ctx.device
    pool = scenes.request_pool(ctx.seed, tr, s, dev)
    state = make_state_dict(ref_mvsnet.MVSNet().state_dict(), ctx.seed, dev)
    model = MVSNet(dtype=dtype_of(s["dtype"]), fused_conv0=s["fused_conv0"])
    model.load_state_dict(state)
    infer = make_infer_step(model, dev)
    requests = [tuple(torch.from_numpy(r[k]) for k in ("imgs", "proj_matrices", "depth_values")) for r in pool]
    stages = StageEvents(model) if ctx.trace else None

    def serve(req):
        out = infer(*req)
        return out["depth"].cpu(), out["photometric_confidence"].cpu()

    for i in range(tr["warm"]):
        serve(requests[i % len(requests)])

    sync(dev)
    tracer = DeviceTrace(f"{ctx.work_dir}/trace.json") if ctx.trace else None
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    answers, walls = [], []
    while time.perf_counter() - t0 < ctx.seconds:
        req = requests[len(answers) % len(requests)]
        t = time.perf_counter()
        if stages:
            stages.begin()
        answers.append(serve(req))
        walls.append(time.perf_counter() - t)
    window = time.perf_counter() - t0
    trace = tracer.stop() if tracer else None
    spans = stages.spans_ms() if stages else {}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n = len(answers)
    del model, infer
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.default_rng([ctx.seed, 4])
    sample = sorted(rng.choice(n, size=min(tr["checked"], n), replace=False).tolist())
    checked = [pool[i % len(pool)] for i in sample]
    want = reference_answers(state, checked, s, dev)
    numbers = relative_errors([answers[i] for i in sample], want,
                              reference_answers(state, checked, s, dev, ctx.workload["control"]), s)
    limits = ctx.workload["limits"]
    checks = [Check(k, numbers[k], limits[k]) for k in limits]

    V, (H, W), D = s["views"], s["img_hw"], s["numdepth"]
    dt = "bf16" if s["dtype"] == "bfloat16" else "f32"
    record = {"numbers": numbers, "requests": n, "depthmaps": n, "window_s": window, "walls_s": walls,
              "spans_ms": spans, "trace": trace, "flops_per_depthmap": roofline.forward_flops(1, V, D, H, W),
              "shapes": {"B": 1, "V": V, "D": D, "H": H, "W": W, "h": H // 4, "w": W // 4, "C": 32, "feat": dt,
                         "vol": dt, "logits": dt}}
    e2e = {"depthmaps_per_s": n / window, "request_p95_s": percentile(walls, 95), "setup_s": setup_s}
    return Outcome(e2e=e2e, record=record, checks=checks,
                   attempted=n, failed=0, memory_peak_bytes=peak, trace=trace)


def reference_answers(state: dict, requests: list[dict], setting: dict, device, control: str | None = None):
    """The plain reference's (depth, confidence) for each request, f32 with
    TF32 off (or under ``control``'s rounding)."""
    with exact(), torch.no_grad():
        model = ref_mvsnet.MVSNet().to(device).eval()
        model.load_state_dict(state)
        out = []
        for r in requests:
            imgs, proj, dv = (torch.as_tensor(r[k]).to(device) for k in ("imgs", "proj_matrices", "depth_values"))
            d, c = model(imgs.float() / 255.0, proj.float(), dv.float(), rounding(control))
            out.append((d.cpu(), c.cpu()))
    return out


def relative_errors(answers, want, control, setting: dict) -> dict[str, float]:
    """``errors`` of the answers and of the control's answers, and their
    ratios (``depth_err_rel``, ``conf_err_rel``)."""
    mine, ctl = errors(answers, want, setting), errors(control, want, setting)
    return {**mine, "depth_err_rel": mine["depth_err"] / ctl["depth_err"],
            "conf_err_rel": mine["conf_err"] / ctl["conf_err"]}


def errors(answers, refs, setting: dict) -> dict[str, float]:
    """|depth - reference| over the depth range and |confidence -
    reference|, each its mean and its median over every pixel of every
    answer."""
    span = setting["numdepth"] * setting["depth_interval"] * setting["interval_scale"]
    d = torch.cat([(a[0].float() - r[0]).abs().reshape(-1) for a, r in zip(answers, refs)]).double() / span
    c = torch.cat([(a[1].float() - r[1]).abs().reshape(-1) for a, r in zip(answers, refs)]).double()
    return {"depth_err": float(d.mean()), "depth_err_median": float(d.median()), "conf_err": float(c.mean()),
            "conf_err_median": float(c.median())}
