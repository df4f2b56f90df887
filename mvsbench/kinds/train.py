"""Training traffic: MVSNet train steps back to back, as the port's Trainer
drives them.

Set-up builds one train step (``train/state.py::make_train_step``: the
model in the configuration's dtype, Adam and the MultiStepLR schedule) with
weights from the seed, and one endless feed: u8 host batches from a pool of
distinct scenes made from the seed, through a ``Loader`` and
``data/pipeline.py::prefetch_to_device`` (pinned staging, the copy to the card
a batch ahead). Its first three steps go through that feed and that step; they
warm up every shape and are what the reference follows. The same step and
feed then run for the window. ``train_step_s`` is the window over the steps
it completed (the window ends when the last one has).

Correctness: the plain f32 reference, from the same initial weights, takes
the same three batches with Adam at the same learning rate. ``step_numbers``
gives each step's loss gap, the first step's depth maps' error, and the
norms of the first gradient (the program's from Adam's first moment after
one step, m / (1 - beta1)) and of the parameters' change over the three
steps (before step 4), by the worst leaf and by the median leaf; the
workload file's ``limits`` name the ones compared. Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone (CostRegNet's last bias, under the softmax) and are left out.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import roofline, scenes
from ..core import Check, Ctx, Outcome, leaf_gap, moving_leaves, sync
from ..reference import mvsnet as ref_mvsnet
from ..reference.precision import exact, rounding
from ..timing import DeviceTrace, StageEvents
from ..weights import make_state_dict

CHECKED_STEPS = 3
BETA1 = 0.9


class Samples:
    """The pool's samples, repeated ``repeats`` times: a map-style dataset
    for the port's ``Loader``."""

    def __init__(self, batches: list[dict], repeats: int):
        self.samples = [{k: b[k][i] for k in b} for b in batches for i in range(len(b["imgs"]))]
        self.repeats = repeats

    def __len__(self) -> int:
        return len(self.samples) * self.repeats

    def __getitem__(self, i: int) -> dict:
        return self.samples[i % len(self.samples)]


def dtype_of(name: str) -> torch.dtype | None:
    return {"bfloat16": torch.bfloat16, "float32": None}[name]


def build(ctx: Ctx, state: dict):
    """The port's model, optimizer and train step from ``state``."""
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet
    from scene_3dreconstruction_mvsnet_tpu_torch.train import make_optimizer, make_scheduler, make_train_step

    s = ctx.config["train"]
    model = MVSNet(dtype=dtype_of(s["dtype"])).to(ctx.device)
    model.load_state_dict(state)
    opt = make_optimizer(model, s["lr"])
    step = make_train_step(model, opt, make_scheduler(opt, s["lrepochs"], s["steps_per_epoch"]), ctx.device)
    return model, opt, step


def feed(ctx: Ctx, batches: list[dict], steps: int):
    from scene_3dreconstruction_mvsnet_tpu_torch.data import Loader, pack_u8_imgs, prefetch_to_device

    B = ctx.config["train"]["batch"]
    samples = Samples(batches, -(-steps * B // (len(batches) * B)) + 1)
    loader = Loader(samples, batch_size=B, drop_last=True, num_workers=ctx.traffic["workers"])
    return prefetch_to_device(loader, ctx.device, transform=pack_u8_imgs)


def run(ctx: Ctx) -> Outcome:
    s, dev = ctx.config["train"], ctx.device
    template = ref_mvsnet.MVSNet().state_dict()
    state = make_state_dict(template, ctx.seed, dev)
    model, opt, step = build(ctx, state)
    pool = scenes.train_pool(ctx.seed, ctx.traffic, s, dev)
    stages = StageEvents(model, opt) if ctx.trace else None
    batches = feed(ctx, pool, ctx.traffic["max_steps"])

    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    first, losses, grad1 = [], [], {}
    for i in range(CHECKED_STEPS):
        host, on_device = next(batches)
        first.append(host)
        aux = step(on_device)
        losses.append(aux["loss"].detach().clone())
        if i == 0:
            depth1 = aux["depth_est"].detach().float().clone()
            grad1 = {n: opt.state[p]["exp_avg"].detach().clone() / (1 - BETA1)
                     for n, p in model.named_parameters() if "exp_avg" in opt.state.get(p, {})}
    change = {n: p.detach() - p0[n] for n, p in model.named_parameters()}
    grad1 = {n: grad1.get(n, torch.zeros_like(p0[n])) for n in p0}  # a leaf Adam never stepped has no moment
    if len({h["imgs"].tobytes() for h in first}) != CHECKED_STEPS:
        raise RuntimeError("the checked steps must see distinct batches")

    sync(dev)
    tracer = DeviceTrace(f"{ctx.work_dir}/trace.json") if ctx.trace else None
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    n = 0
    while n < ctx.traffic["max_steps"]:
        _, on_device = next(batches)
        if stages:
            stages.begin()
        step(on_device)
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(dev)
    window = time.perf_counter() - t0
    trace = tracer.stop() if tracer else None
    spans = stages.spans_ms() if stages else {}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    batches.close()
    losses = [float(x) for x in losses]
    del model, opt, step, batches, on_device, aux
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers, worst = step_numbers((losses, grad1, change, depth1.cpu()), reference_steps(state, first, s["lr"], dev),
                                  depth_span(s))
    limits = ctx.workload["limits"]
    checks = [Check(k, numbers[k], limits[k]) for k in limits]
    ctx.log(f"losses {losses}; numbers {numbers}; worst leaves {worst}")

    B, V, (H, W), D = s["batch"], s["views"], s["img_hw"], s["numdepth"]
    record = {"numbers": numbers, "steps": n, "window_s": window, "spans_ms": spans, "trace": trace,
              "shapes": {"B": B, "V": V, "D": D, "H": H, "W": W, "h": H // 4, "w": W // 4, "C": 32,
                         "feat": "bf16" if s["dtype"] == "bfloat16" else "f32",
                         "vol": "bf16" if s["dtype"] == "bfloat16" else "f32"},
              "flops_per_step": roofline.train_step_flops(B, V, D, H, W)}
    return Outcome(e2e={"train_step_s": window / n, "setup_s": setup_s}, record=record, checks=checks,
                   attempted=n, failed=0, memory_peak_bytes=peak, trace=trace)


def depth_span(setting: dict) -> float:
    return setting["numdepth"] * setting["depth_interval"] * setting["interval_scale"]


def step_numbers(got, want, span: float) -> tuple[dict[str, float], dict[str, str]]:
    """Three train steps against the reference's, each a (losses, first
    gradient, change, first depth map) tuple: the largest relative loss gap
    over the steps and the first step's; by the worst leaf and by the median
    leaf the gap of the first gradient's norm and of the change's norm, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger (leaves whose reference gradient is under a thousandth of the
    median leaf's left out); and the first step's depth maps' absolute
    error over the depth range, its mean and its median -> (numbers, the
    worst leaves)."""
    keep = moving_leaves(want[1])
    loss = [abs(a - b) / abs(b) for a, b in zip(got[0], want[0])]
    grad, grad_leaf, grad_median = leaf_gap(got[1], want[1], keep)
    change, change_leaf, change_median = leaf_gap(got[2], want[2], keep)
    same = got[3].shape == want[3].shape
    err = (got[3].double() - want[3].double()).abs() / span if same else None
    depth1, depth1_median = (float(err.mean()), float(err.median())) if same else (float("inf"), float("inf"))
    return ({"loss_gap": max(loss), "loss1_gap": loss[0], "grad_gap": grad, "grad_gap_median": grad_median,
             "change_gap": change, "change_gap_median": change_median, "depth1_err": depth1,
             "depth1_err_median": depth1_median},
            {"grad": grad_leaf, "change": change_leaf, "left_out": ",".join(sorted(set(want[1]) - set(keep)))})


def reference_steps(state: dict, batches: list[dict], lr: float, device, control: str | None = None):
    """The plain reference's train steps on ``batches`` from ``state``:
    (losses, each leaf's first gradient, each leaf's change after the
    last, the first step's depth maps on the host), in f32 with TF32 off (or
    under ``control``'s rounding)."""
    with exact():
        model = ref_mvsnet.MVSNet().to(device)
        model.load_state_dict(state)
        model.train()
        opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(BETA1, 0.999), eps=1e-8)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        losses, grad1 = [], {}
        for i, b in enumerate(batches):
            t = {k: torch.as_tensor(np.asarray(b[k])).to(device) for k in ("imgs", "proj_matrices", "depth_values",
                                                                         "depth", "mask")}
            depth, _ = model(t["imgs"].float() / 255.0, t["proj_matrices"].float(), t["depth_values"].float(),
                             rounding(control))
            loss = ref_mvsnet.masked_smooth_l1(depth, t["depth"].float(), t["mask"].float())
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if i == 0:
                grad1 = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
                depth1 = depth.detach().cpu()
            opt.step()
            losses.append(float(loss.detach()))
            del depth, loss, t
        change = {n: p.detach() - p0[n] for n, p in model.named_parameters()}
    return losses, grad1, change, depth1
