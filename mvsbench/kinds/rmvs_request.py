"""R-MVSNet request traffic: one client in a closed loop on the serving entry,
the model R-MVSNet.

Set-up looks the port's R-MVSNet up (``models.find_model_def("rmvsnet")``; a
port without it fails here, before anything else), builds
``infer.py::make_infer_step`` around it in the configuration's eval dtype,
with weights from the seed (``weights.make_state_dict`` over the reference
R-MVSNet's state dict), and takes the same pool of requests as ``request``
(``scenes.request_pool``: u8 views of a ring, their projections at 1/4
resolution, the D depth planes). A request hands the host arrays to the
entry and ends when the winner-take-all depth and its probability are on the
host, copied into the client's two response buffers ([1, h, w] f32, made at
set-up); the next is sent then. The requests' host arrays are pinned at
set-up, as the response buffers are made then: from pageable memory the
29 MB of images a request are copied by the host's CPU on the request's
critical path, at the speed of a host whose memory other tenants share.
Warm-up serves ``warm`` requests (the first captures the plane step's CUDA
graph). ``depthmaps_per_s`` and ``request_p95_s`` are ``request``'s.

Correctness is ``cascade_request``'s in form: a reservoir sample of the
window's requests, drawn from the seed, answered again by the plain f32
reference (``reference/rmvsnet.py``) and by the reference under the cell's
``control`` rounding; each error over the control's own error on the same
answers. The errors (``errors``): the depth's, in the reference's logits
(``depth_regret``: the mean over pixels of max_t L(t) - L(t'), t' the plane
of the answer's depth, nearest where it lies between planes), and the
probability's (``conf_err``, its mean absolute error). A depth error in
millimetres (``depth_err``, recorded, not checked) cannot tell a fault from
rounding here: with random weights a pixel's best planes' logits often lie
within bf16's rounding of each other, any rounding then picks one of them,
and a plane far off costs the same millimetres as a wrong answer. The regret
of such a pick is the logits' difference, near 0.

With ``--trace 1`` the window runs under ``spans.SpanDeviceTrace`` (the port's
span tracer on, its launch counts reset) and ends after ``traced`` requests
(or ``--seconds``): a whole window's trace would hold ~6.5 M kernels (256
planes of ~90 kernels a request), more than the trace's export and the
span join take in a run's time. The record holds the shapes for the
readers. ``readings`` gives the control's and the faults' numbers
from which the cell's limits are set (``mvsbench/rmvs_control.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import roofline_rmvs, scenes
from ..core import Check, Ctx, Outcome, percentile, sync
from ..reference import rmvsnet as ref_rmvs
from ..reference.precision import exact, rounding
from ..spans import SpanDeviceTrace
from ..weights import make_state_dict
from .cascade_request import log_spans
from .request import errors as abs_errors
from .train import dtype_of


def run(ctx: Ctx) -> Outcome:
    from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
    from scene_3dreconstruction_mvsnet_tpu_torch.models import find_model_def

    try:
        rmvsnet = find_model_def("rmvsnet")
    except KeyError as e:
        raise ImportError(f"the port has no R-MVSNet: {e}") from None
    s, tr, dev = ctx.config["eval"], ctx.traffic, ctx.device
    pool = scenes.request_pool(ctx.seed, tr, s, dev)
    state = make_state_dict(ref_rmvs.RMVSNet().state_dict(), ctx.seed, dev)
    model = rmvsnet(dtype=dtype_of(s["dtype"]))
    model.load_state_dict(state)
    infer = make_infer_step(model, dev)
    pin = dev.type == "cuda"
    requests = [tuple(torch.from_numpy(r[k]).pin_memory() if pin else torch.from_numpy(r[k])
                      for k in ("imgs", "proj_matrices", "depth_values")) for r in pool]

    V, (H, W), D = s["views"], s["img_hw"], s["numdepth"]
    response = (torch.zeros((1, H // 4, W // 4)), torch.zeros((1, H // 4, W // 4)))

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
    while time.perf_counter() - t0 < ctx.seconds and not (tracer and len(walls) == tr["traced"]):
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
    want = reference_answers(state, checked, dev, logits=True)
    numbers = relative_errors([answer for _, answer in kept], want,
                              reference_answers(state, checked, dev, ctx.workload["control"]), checked, s)
    limits = ctx.workload["limits"]
    checks = [Check(k, numbers[k], limits[k]) for k in limits]

    dt = "bf16" if s["dtype"] == "bfloat16" else "f32"
    record = {"numbers": numbers, "requests": n, "depthmaps": n, "window_s": window, "walls_s": walls,
              "trace": trace, "flops_per_depthmap": roofline_rmvs.forward_flops(1, V, D, H, W),
              "shapes": {"B": 1, "V": V, "D": D, "H": H, "W": W, "h": H // 4, "w": W // 4, "C": 32, "feat": dt,
                         "vol": dt}}
    e2e = {"depthmaps_per_s": n / window, "request_p95_s": percentile(walls, 95), "setup_s": setup_s}
    return Outcome(e2e=e2e, record=record, checks=checks,
                   attempted=n, failed=0, memory_peak_bytes=peak, trace=trace)


def reference_answers(state: dict, requests: list[dict], device, control: str | None = None,
                      fault: str | None = None, logits: bool = False):
    """The plain reference's (depth, probability) for each request, f32 with
    TF32 off (or under ``control``'s rounding, or with ``fault``); with
    ``logits``, (depth, probability, logit maps [1, D, h, w])."""
    with exact(), torch.no_grad():
        model = ref_rmvs.RMVSNet().to(device).eval()
        model.load_state_dict(state)
        out = []
        for r in requests:
            imgs, proj, dv = (torch.as_tensor(r[k]).to(device) for k in ("imgs", "proj_matrices", "depth_values"))
            got = model(imgs.float() / 255.0, proj.float(), dv.float(), rounding(control), fault)
            keep = ("depth", "photometric_confidence", "logits") if logits else ("depth", "photometric_confidence")
            out.append(tuple(got[k].cpu() for k in keep))
    return out


def regret(depth: torch.Tensor, planes: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """depth [1, h, w], planes [D] ascending, logits [1, D, h, w] -> per pixel
    max_t L(t) - L(t'), t' the plane nearest to ``depth``."""
    D, d = planes.shape[0], depth.reshape(-1).contiguous()
    upper = torch.searchsorted(planes, d).clamp(1, D - 1)
    index = torch.where(d - planes[upper - 1] <= planes[upper] - d, upper - 1, upper)
    maps = logits.reshape(D, -1)
    return maps.max(0).values - maps.gather(0, index[None])[0]


def errors(answers, want, requests: list[dict], setting: dict) -> dict[str, float]:
    """``request.errors`` (the mean absolute depth error over the depth range
    and the probability's, and their medians) and ``depth_regret``, against
    ``want`` (the reference's answers with their logits)."""
    regrets = torch.cat([regret(a[0].float(), torch.as_tensor(r["depth_values"])[0], w[2]).double()
                         for a, w, r in zip(answers, want, requests)])
    return {**abs_errors(answers, want, setting), "depth_regret": float(regrets.mean())}


def relative_errors(answers, want, control, requests: list[dict], setting: dict) -> dict[str, float]:
    """``errors`` of the answers and of the control's answers, and their
    ratios: ``depth_err_rel`` of the regret, ``conf_err_rel`` of the
    probability's error."""
    mine, ctl = errors(answers, want, requests, setting), errors(control, want, requests, setting)
    return {**mine, "depth_err_rel": mine["depth_regret"] / ctl["depth_regret"],
            "conf_err_rel": mine["conf_err"] / ctl["conf_err"]}


def readings(ctx: Ctx) -> dict[str, dict]:
    """On the seed's first ``checked`` pool requests: the control, the
    reference rounded to bf16 (a witness of the program's own precision)
    and each of the reference's faults, each over the control's error on
    the same answers; and ``maps``, how far the reference's maps are from
    degenerate: the planes its depth takes, the share of pixels whose depth
    ``no_recurrence`` moves, and the mean probability over 1/D."""
    s = ctx.config["eval"]
    control = ctx.workload["control"]
    state = make_state_dict(ref_rmvs.RMVSNet().state_dict(), ctx.seed, ctx.device)
    reqs = scenes.request_pool(ctx.seed, ctx.traffic, s, ctx.device)[: ctx.traffic["checked"]]
    want = reference_answers(state, reqs, ctx.device, logits=True)
    ctl = reference_answers(state, reqs, ctx.device, control)
    out = {"control_" + control: relative_errors(ctl, want, ctl, reqs, s),
           "bf16_rounding": relative_errors(reference_answers(state, reqs, ctx.device, "bf16"), want, ctl, reqs, s)}
    faults = {f: reference_answers(state, reqs, ctx.device, None, f) for f in ref_rmvs.FAULTS}
    for fault, got in faults.items():
        out["fault_" + fault] = relative_errors(got, want, ctl, reqs, s)
    depth = torch.stack([w[0] for w in want])
    moved = torch.stack([d for d, _ in faults["no_recurrence"]]) != depth
    out["maps"] = {"planes_used": float(depth.unique().numel()), "no_recurrence_moved": float(moved.double().mean()),
                   "prob_over_uniform": float(torch.stack([w[1] for w in want]).double().mean() * s["numdepth"])}
    return out
