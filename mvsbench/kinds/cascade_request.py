"""Cascade request traffic: one client in a closed loop on the serving entry,
the model CasMVSNet.

Set-up looks the port's CasMVSNet up (``models.find_model_def("casmvsnet")``;
a port without it fails here, before anything else), builds
``infer.py::make_infer_step`` around it in the configuration's eval dtype,
with weights from the seed (``weights.make_state_dict`` over the reference
CasMVSNet's state dict), and takes the same pool of requests as ``request``
(``scenes.request_pool``: u8 views of a ring, their projections at 1/4
resolution, the D0 depth values). A request hands the host arrays to the
entry and ends when stage 3's depth and confidence are on the host, copied
into the client's two response buffers (8 MB at this resolution, allocated
and touched at set-up, so that no request faults in fresh pages); the next
is sent then. Warm-up serves ``warm`` requests. ``depthmaps_per_s`` and
``request_p95_s`` are ``request``'s.

Correctness is ``request``'s, with its helpers: a sample of the window's
requests, drawn from the seed, answered again by the plain f32 reference
(``reference/casmvsnet.py``) and by the reference under the cell's
``control`` rounding; the mean absolute depth and confidence errors of the
final maps, each over the control's own error on the same answers. The
sample is drawn while the window runs (reservoir sampling, uniform over the
window's requests) and only its answers are copied out of the response
buffers, after the request's latency is taken: keeping every answer would
grow the host's memory by 8 MB a request.

With ``--trace 1`` the window runs under ``spans.SpanDeviceTrace`` (the port's
span tracer on, its launch counts reset), and the record holds the three
stages' shapes for the readers. ``readings`` gives the control's and the
faults' numbers from which the cell's limits are set
(``mvsbench/cascade_control.py``).
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from .. import roofline_cascade, scenes
from ..core import Check, Ctx, Outcome, percentile, sync
from ..reference import casmvsnet as ref_cas
from ..reference.precision import exact, rounding
from ..spans import SpanDeviceTrace
from ..weights import make_state_dict
from .request import relative_errors
from .train import dtype_of


def run(ctx: Ctx) -> Outcome:
    from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
    from scene_3dreconstruction_mvsnet_tpu_torch.models import find_model_def

    try:
        cas_mvsnet = find_model_def("casmvsnet")
    except KeyError as e:
        raise ImportError(f"the port has no CasMVSNet: {e}") from None
    c, s, tr, dev = ctx.config, ctx.config["eval"], ctx.traffic, ctx.device
    pool = scenes.request_pool(ctx.seed, tr, s, dev)
    state = make_state_dict(reference(c).state_dict(), ctx.seed, dev)
    model = cas_mvsnet(dtype=dtype_of(s["dtype"]), ndepths=tuple(c["ndepths"]),
                       depth_interval_ratio=tuple(c["depth_inter_r"]))
    model.load_state_dict(state)
    infer = make_infer_step(model, dev)
    requests = [tuple(torch.from_numpy(r[k]) for k in ("imgs", "proj_matrices", "depth_values")) for r in pool]

    V, (H, W) = s["views"], s["img_hw"]
    response = (torch.zeros((1, H, W)), torch.zeros((1, H, W)))

    def serve(req):
        out = infer(*req)
        response[0].copy_(out["depth"])
        response[1].copy_(out["photometric_confidence"])

    for i in range(tr["warm"]):
        serve(requests[i % len(requests)])

    sync(dev)
    tracer = SpanDeviceTrace(f"{ctx.work_dir}/trace.json") if ctx.trace else None
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    rng, kept, walls = np.random.default_rng([ctx.seed, 4]), [], []
    while time.perf_counter() - t0 < ctx.seconds:
        n = len(walls)
        t = time.perf_counter()
        serve(requests[n % len(requests)])
        walls.append(time.perf_counter() - t)
        if n < tr["checked"]:
            kept.append((n, tuple(r.clone() for r in response)))
        elif (j := rng.integers(0, n + 1)) < tr["checked"]:
            kept[j] = (n, tuple(r.clone() for r in response))
    window = time.perf_counter() - t0
    trace = tracer.stop() if tracer else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n = len(walls)
    del model, infer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        log_spans(ctx, trace, n)

    kept.sort(key=lambda item: item[0])
    checked = [pool[i % len(pool)] for i, _ in kept]
    want = reference_answers(c, state, checked, dev)
    numbers = relative_errors([answer for _, answer in kept], want,
                              reference_answers(c, state, checked, dev, ctx.workload["control"]), s)
    limits = ctx.workload["limits"]
    checks = [Check(k, numbers[k], limits[k]) for k in limits]

    dt = "bf16" if s["dtype"] == "bfloat16" else "f32"
    record = {"numbers": numbers, "requests": n, "depthmaps": n, "window_s": window, "walls_s": walls,
              "trace": trace, "flops_per_depthmap": roofline_cascade.forward_flops(1, V, H, W, c["ndepths"]),
              "stages": roofline_cascade.stages(H, W, c["ndepths"]),
              "shapes": {"B": 1, "V": V, "H": H, "W": W, "feat": dt, "vol": dt, "logits": dt}}
    e2e = {"depthmaps_per_s": n / window, "request_p95_s": percentile(walls, 95), "setup_s": setup_s}
    return Outcome(e2e=e2e, record=record, checks=checks,
                   attempted=n, failed=0, memory_peak_bytes=peak, trace=trace)


def reference(config: dict) -> ref_cas.CasMVSNet:
    return ref_cas.CasMVSNet(ndepths=config["ndepths"], ratios=config["depth_inter_r"])


def reference_answers(config: dict, state: dict, requests: list[dict], device, control: str | None = None,
                      fault: str | None = None):
    """The plain reference's final (depth, confidence) for each request, f32
    with TF32 off (or under ``control``'s rounding, or with ``fault``)."""
    with exact(), torch.no_grad():
        model = reference(config).to(device).eval()
        model.load_state_dict(state)
        out = []
        for r in requests:
            imgs, proj, dv = (torch.as_tensor(r[k]).to(device) for k in ("imgs", "proj_matrices", "depth_values"))
            got = model(imgs.float() / 255.0, proj.float(), dv.float(), rounding(control), fault)
            out.append((got["depth"].cpu(), got["photometric_confidence"].cpu()))
    return out


def readings(ctx: Ctx) -> dict[str, dict]:
    """On the seed's first ``checked`` pool requests: the control, the
    reference rounded to bf16 (a witness of the program's own precision)
    and each of the reference's faults, each over the control's error on
    the same answers."""
    c, s = ctx.config, ctx.config["eval"]
    control = ctx.workload["control"]
    state = make_state_dict(reference(c).state_dict(), ctx.seed, ctx.device)
    reqs = scenes.request_pool(ctx.seed, ctx.traffic, s, ctx.device)[: ctx.traffic["checked"]]
    want = reference_answers(c, state, reqs, ctx.device)
    ctl = reference_answers(c, state, reqs, ctx.device, control)
    out = {"control_" + control: relative_errors(ctl, want, ctl, s),
           "bf16_rounding": relative_errors(reference_answers(c, state, reqs, ctx.device, "bf16"), want, ctl, s)}
    for fault in ref_cas.FAULTS:
        out["fault_" + fault] = relative_errors(reference_answers(c, state, reqs, ctx.device, None, fault), want, ctl, s)
    return out


def log_spans(ctx: Ctx, trace: dict, n: int) -> None:
    """The traced window's spans on stderr: each span's mean device ms, the
    idle seconds by span and the kernel launches a request."""
    device_ms = {k: statistics.fmean(v) for k, v in trace.get("span_device_ms", {}).items()}
    ctx.log("span device ms " + json.dumps(device_ms, sort_keys=True))
    ctx.log("idle s by span " + json.dumps(trace.get("idle_by_span", {}), sort_keys=True))
    ctx.log("launches a request " + json.dumps({k: v / n for k, v in trace.get("launches", {}).items() if v}))
