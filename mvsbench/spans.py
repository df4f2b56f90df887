"""The port's own spans and launch counts, joined with the device trace.

The port records spans on the host clock (``utils/tracing.py`` of the port:
name, start, end, parent, the thread's native and pthread ids, item id) and
counts its
hand-written kernels' launches. ``SpanDeviceTrace`` is ``DeviceTrace`` with
both on over the traced window: it resets the launch counts and enables the
tracer after the profiler starts, and takes the spans before it stops.
``join`` puts the spans on the exported trace's clock (the trace's ``ts``
plus ``baseTimeNanoseconds`` / 1e3 is Unix time in µs, and so is a span's
stamp plus the tracer's ``offset_ns``) and reads, beside ``reduce_trace``'s
keys, which it leaves as they are:

- ``span_device_ms``: for each span name, each occurrence's device time,
  from the start of the first device operation launched inside it to the end
  of the last one. A launch (a ``cuda_runtime`` or ``cuda_driver`` event,
  joined to its operation by ``args.correlation``; its ``tid`` is CUPTI's,
  the thread's pthread id cut to 32 bits) belongs to the innermost span
  open on its own thread at its time, else to the innermost (the latest
  opened) span open on any thread; it is inside that span and every
  ancestor.
- ``idle_by_span``: the window's idle seconds by span name. Each gap between
  the union's intervals (and the window's head and tail) goes to the
  innermost span open at its middle on the thread that launched the
  operation ending it, else on any thread, else to OUTSIDE (the harness's own
  work, such as the copy of the answers to the host). The labels sum to the
  window minus the union of the device's intervals within it.
- ``program_spans``: for each span name its count and mean host ms, and the
  mean self ms (the duration minus what its child spans cover).
- ``launches``: each kernel's launches over the window.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import time
from collections import defaultdict

import torch

from .timing import DEVICE_CATEGORIES, HOST_CATEGORIES, DeviceTrace, reduce_trace

OUTSIDE = "outside the program's spans"


class SpanDeviceTrace(DeviceTrace):
    """``DeviceTrace`` with the port's tracer on and its launch counts reset
    over the window; ``stop`` adds ``join``'s keys to ``reduce_trace``'s."""

    def start(self) -> None:
        from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import reset_launch_counts
        from scene_3dreconstruction_mvsnet_tpu_torch.utils import tracing

        super().start()
        reset_launch_counts()
        tracing.enable()

    def stop(self) -> dict:
        from scene_3dreconstruction_mvsnet_tpu_torch.utils import tracing

        torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        taken = tracing.take()
        tracing.disable()
        self.prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            return reduce_with_spans(self.path, window, taken, round(self.t0 * 1e9))
        finally:
            os.remove(self.path)


def reduce_with_spans(path: str, window_s: float, taken: dict, t0_ns: int) -> dict:
    """``reduce_trace(path, window_s)``'s keys as it gives them, and
    ``join``'s, the window starting at ``t0_ns`` on the spans' clock."""
    with open(path) as f:
        trace = json.load(f)
    return {**reduce_trace(path, window_s), **join(trace, taken, (t0_ns, t0_ns + round(window_s * 1e9)))}


def _segments(intervals: list[tuple[float, float, int]]) -> tuple[list[float], list[int | None]]:
    """(start, end, index) intervals -> (times, owners): from ``times[k]``
    to ``times[k + 1]`` the innermost open interval is ``owners[k]`` (the
    latest started; None where none is open)."""
    bounds = sorted([(s, 1, i) for s, _, i in intervals] + [(e, 0, i) for _, e, i in intervals])
    start = {i: s for s, _, i in intervals}
    open_, times, owners = set(), [], []
    for t, opening, i in bounds:
        (open_.add if opening else open_.discard)(i)
        owner = max(open_, key=lambda j: (start[j], j)) if open_ else None
        if times and times[-1] == t:
            owners[-1] = owner
        else:
            times.append(t)
            owners.append(owner)
    return times, owners


def _owner(segments, t: float) -> int | None:
    times, owners = segments
    k = bisect.bisect_right(times, t) - 1
    return owners[k] if k >= 0 else None


def join(trace: dict, taken: dict, window_ns: tuple[int, int]) -> dict:
    """A chrome trace (the exported JSON), the port's ``tracing.take()`` and
    the window's start and end on the spans' clock (``perf_counter`` ns) ->
    {'span_device_ms', 'idle_by_span', 'program_spans', 'launches'}."""
    shift_ns = taken["offset_ns"] - int(trace.get("baseTimeNanoseconds", 0))
    to_ts = lambda ns: (ns + shift_ns) / 1e3  # noqa: E731 (a stamp on the trace's ts, µs)
    closed = [k for k, s in enumerate(taken["spans"]) if s["end_ns"] is not None]
    renumber = {old: new for new, old in enumerate(closed)}
    spans = [taken["spans"][k] for k in closed]
    parent = [renumber.get(s["parent"]) for s in spans]
    ivals = [(to_ts(s["start_ns"]), to_ts(s["end_ns"])) for s in spans]

    by_thread: dict[int, list] = defaultdict(list)
    thread_of: dict[int, int] = {}  # a launch's tid (CUPTI's: the pthread id's low 32 bits) -> native id
    for k, (s, e) in enumerate(ivals):
        by_thread[spans[k]["tid"]].append((s, e, k))
        thread_of[spans[k]["ident"] & 0xFFFFFFFF] = spans[k]["tid"]
    thread_seg = {tid: _segments(v) for tid, v in by_thread.items()}
    any_seg = _segments([(s, e, k) for k, (s, e) in enumerate(ivals)])

    def owner(t: float, tid) -> int | None:
        native = thread_of.get(tid & 0xFFFFFFFF) if isinstance(tid, int) else None
        k = _owner(thread_seg[native], t) if native is not None else None
        return k if k is not None else _owner(any_seg, t)

    launches, ops = {}, []
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, corr = e.get("cat", ""), (e.get("args") or {}).get("correlation")
        if cat in HOST_CATEGORIES and corr is not None:
            launches[corr] = (float(e["ts"]), e.get("tid"))
        elif cat in DEVICE_CATEGORIES:
            ops.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), corr))
    ops.sort()

    first, last = [None] * len(spans), [None] * len(spans)
    op_tid = []
    for s, e, corr in ops:
        at = launches.get(corr)
        op_tid.append(at[1] if at else None)
        k = owner(*at) if at else None
        while k is not None:
            first[k] = s if first[k] is None else min(first[k], s)
            last[k] = e if last[k] is None else max(last[k], e)
            k = parent[k]
    device_ms: dict[str, list[float]] = defaultdict(list)
    for k, s in enumerate(spans):
        if first[k] is not None:
            device_ms[s["name"]].append((last[k] - first[k]) / 1e3)

    ws, we = to_ts(window_ns[0]), to_ts(window_ns[1])
    idle: dict[str, float] = defaultdict(float)

    def gap(a: float, b: float, tid) -> None:
        a, b = max(a, ws), min(b, we)
        if b > a:
            k = owner((a + b) / 2, tid)
            idle[OUTSIDE if k is None else spans[k]["name"]] += (b - a) / 1e6

    end = ws
    for (s, e, _), tid in zip(ops, op_tid):
        if s > end:
            gap(end, s, tid)
        end = max(end, e)
    gap(end, we, None)

    children: dict[int, list] = defaultdict(list)
    for k, p in enumerate(parent):
        if p is not None:
            children[p].append(ivals[k])
    durations: dict[str, list[float]] = defaultdict(list)
    selfs: dict[str, list[float]] = defaultdict(list)
    for k, (s, e) in enumerate(ivals):
        covered, reach = 0.0, s
        for cs, ce in sorted(children[k]):
            cs, ce = max(cs, reach), min(ce, e)
            if ce > cs:
                covered += ce - cs
                reach = ce
        durations[spans[k]["name"]].append((e - s) / 1e3)
        selfs[spans[k]["name"]].append((e - s - covered) / 1e3)
    program = {n: {"n": len(d), "ms": statistics.fmean(d), "self_ms": statistics.fmean(selfs[n])}
               for n, d in durations.items()}
    return {"span_device_ms": dict(device_ms), "idle_by_span": dict(idle), "program_spans": program,
            "launches": dict(taken["launches"])}


def _trace(record: dict) -> dict:
    return record.get("trace") or {}


def mean_device_ms(record: dict, span: str) -> float | None:
    """The mean of ``span_device_ms[span]``, or None."""
    values = _trace(record).get("span_device_ms", {}).get(span)
    return statistics.fmean(values) if values else None


def host_ms_per(record: dict, span: str, items: str | None = None) -> float | None:
    """``span``'s mean host ms an occurrence, or with ``items`` (a count in
    the record) its total host ms over that count; None where missing."""
    got = _trace(record).get("program_spans", {}).get(span)
    if not got:
        return None
    if items is None:
        return got["ms"]
    return got["ms"] * got["n"] / record[items] if record.get(items) else None


def launches_per(record: dict, items: str) -> float | None:
    """The window's launches of the hand-written kernels over ``items``."""
    launches = _trace(record).get("launches")
    if launches is None or not record.get(items):
        return None
    return sum(launches.values()) / record[items]
