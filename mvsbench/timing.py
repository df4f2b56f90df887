"""Spans on the card and the device trace.

``StageEvents`` is chip_smoke.py's ``StageTimer`` kept for every iteration
of a window: CUDA events recorded by module forward hooks, tensor backward
hooks and optimizer step hooks, so the program runs unchanged. The marks, in
the order the device reaches them in a train step:

  model_fwd -> sweep_fwd (FeatureNet done) -> costreg_fwd
  -> head_fwd (CostRegNet done) -> model_end -> costreg_bwd (the logits'
  gradient) -> sweep_bwd (CostRegNet's input gradient) -> feature_bwd (the
  features' gradient) -> optimizer -> after

(an inference request reaches the forward's marks only).

``DeviceTrace`` is chip_smoke.py's ``device_busy`` over a whole window:
``torch.profiler`` with CUDA activity, the trace exported by the profiler and
reduced here to the union of the device's intervals, its operations by
time, and its idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict

import torch

SPANS = {  # name -> (first mark, second mark)
    "sweep_fwd": ("sweep_fwd", "costreg_fwd"),
    "costreg_fwd": ("costreg_fwd", "head_fwd"),
    "regression": ("head_fwd", "model_end"),
    "forward": ("model_fwd", "model_end"),
    "costreg_bwd": ("costreg_bwd", "sweep_bwd"),
    "sweep_bwd": ("sweep_bwd", "feature_bwd"),
    "optimizer": ("optimizer", "after"),
}


class StageEvents:
    """CUDA events at the stage boundaries of every iteration, from hooks on
    ``model`` (an MVSNet of the port) and ``optimizer`` (or None)."""

    def __init__(self, model, optimizer=None):
        self.iters: list[dict[str, torch.cuda.Event]] = []
        mark = self.mark

        def on_grad(name):
            def hook(grad):
                mark(name)
            return hook

        def feature_post(module, args, out):
            mark("sweep_fwd")
            if out.requires_grad:
                out.register_hook(on_grad("feature_bwd"))

        def costreg_pre(module, args):
            mark("costreg_fwd")
            if args[0].requires_grad:
                args[0].register_hook(on_grad("sweep_bwd"))

        def costreg_post(module, args, out):
            mark("head_fwd")
            if out.requires_grad:
                out.register_hook(on_grad("costreg_bwd"))

        self.handles = [
            model.register_forward_pre_hook(lambda m, a: mark("model_fwd")),
            model.register_forward_hook(lambda m, a, o: mark("model_end")),
            model.feature.register_forward_hook(feature_post),
            model.cost_regularization.register_forward_pre_hook(costreg_pre),
            model.cost_regularization.register_forward_hook(costreg_post),
        ]
        if optimizer is not None:
            self.handles += [optimizer.register_step_pre_hook(lambda o, a, k: mark("optimizer")),
                             optimizer.register_step_post_hook(lambda o, a, k: mark("after"))]

    def begin(self) -> None:
        self.iters.append({})

    def mark(self, name: str) -> None:
        if self.iters:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.iters[-1][name] = ev

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def spans_ms(self) -> dict[str, list[float]]:
        """Each span's ms in every iteration that has both of its marks
        (synchronises)."""
        torch.cuda.synchronize()
        out: dict[str, list[float]] = defaultdict(list)
        for marks in self.iters:
            for name, (a, b) in SPANS.items():
                if a in marks and b in marks:
                    out[name].append(marks[a].elapsed_time(marks[b]))
        return dict(out)


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cuda_runtime", "cuda_driver")


class DeviceTrace:
    """``torch.profiler`` over a window (CUDA activity). ``stop`` exports
    the trace to ``path``, reads it and deletes it."""

    def __init__(self, path: str):
        self.path = path
        self.prof = None
        self.t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            return reduce_trace(self.path, window)
        finally:
            os.remove(self.path)


def reduce_trace(path: str, window_s: float) -> dict:
    """A chrome trace -> {'busy_s', 'window_s', 'device_ops', 'idle_gaps'}:
    the union of the device's intervals, the 10 device operations that took
    most time (summed by name) and the 10 labels under which the device sat
    idle longest (summed), each label the CUDA call the host was in at the
    gap's middle, or else the device operation that ended the gap."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            device.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?")))
        elif cat in HOST_CATEGORIES:
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?")))
    device.sort()
    host.sort()
    by_name: dict[str, float] = defaultdict(float)
    for s, e, name in device:
        by_name[name] += (e - s) / 1e6
    merged: list[list] = []
    for s, e, name in device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e, name])
    busy = sum(e - s for s, e, _ in merged) / 1e6
    gaps: dict[str, float] = defaultdict(float)
    starts = [s for s, _, _ in host]
    for prev, nxt in zip(merged, merged[1:]):
        mid = (prev[1] + nxt[0]) / 2
        i = bisect.bisect_right(starts, mid)
        label = next((f"host in {name}" for s, e, name in reversed(host[max(0, i - 64):i]) if e >= mid), None)
        gaps[label or f"host between CUDA calls, before {nxt[2][:60]}"] += (nxt[0] - prev[1]) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s, "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
