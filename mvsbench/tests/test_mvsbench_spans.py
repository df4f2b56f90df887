"""The port's spans joined with the device trace (``mvsbench/spans.py``): a
hand-written chrome trace, with launches on two threads, gives known device
spans, idle seconds by span and host times; ``reduce_trace``'s own keys come
out as they are; and each span reader returns None without its key and its
value on a fixed record."""

import json
import os
import subprocess
import sys

import pytest

from mvsbench import manifest, span_run, spans
from mvsbench.timing import reduce_trace

SHIFT_NS = 2_000_000_000  # the tracer's offset minus the trace's base: a stamp of x ns is at ts x / 1e3 + 2e6 µs
BASE_NS = 1_790_000_000_000_000_000
T1, T2 = 11, 22  # native ids of the caller's thread and of the autograd engine's
IDENT = {T1: 0x7F0011223340, T2: 0x7F00AABBC6C0}  # their pthread ids
CUPTI = {t: i & 0xFFFFFFFF for t, i in IDENT.items()}  # the tid of their launches in the trace


def _span(name, start_us, end_us, parent, tid, item=0):
    return {"name": name, "start_ns": int(start_us * 1e3), "end_ns": None if end_us is None else int(end_us * 1e3),
            "parent": parent, "tid": tid, "ident": IDENT[tid], "item": item}


TAKEN = {
    "offset_ns": BASE_NS + SHIFT_NS,
    "launches": {"sweep_variance_emit": 4, "paired_grad": 1, "warp_grad": 1},
    "spans": [
        _span("train.step", 0, 1000, None, T1),
        _span("train.forward", 10, 400, 0, T1),
        _span("mvsnet.costreg", 100, 300, 1, T1),
        _span("train.backward", 450, 900, 0, T1),
        _span("sweep.backward", 600, 700, 3, T2),
        _span("mvsnet.costreg", 640, 690, 3, T1),  # opened after sweep.backward, on the other thread
        _span("feed.wait", 1280, None, None, T1, 6),  # still open when taken: left out
    ],
}
# (correlation, launching thread, launch at, device op start, end) in µs of the spans' clock. Launches 8 and 5
# fall where the span open on their own thread is not the latest opened: the thread decides.
LAUNCHES = [(1, T1, 20, 30, 90), (2, T1, 110, 120, 200), (3, T1, 250, 210, 320), (4, T2, 500, 500, 590),
            (8, T1, 620, 625, 635), (5, T2, 660, 665, 680), (9, T1, 670, 770, 780), (6, T2, 690, 700, 760),
            (7, T1, 1200, 1210, 1250)]
WINDOW_US = (-100, 1300)


def _trace() -> dict:
    ts = lambda us: us + SHIFT_NS / 1e3  # noqa: E731
    events = [{"ph": "i", "cat": "cpu_instant_event", "name": "start", "ts": ts(-100), "pid": 1, "tid": T1},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": ts(1260), "dur": 30,
               "pid": 1, "tid": CUPTI[T1], "args": {"correlation": 99}}]
    for corr, tid, at, s, e in LAUNCHES:
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts(at), "dur": 4,
                       "pid": 1, "tid": CUPTI[tid], "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "gpu_memcpy" if corr == 4 else "kernel", "name": f"op{corr}",
                       "ts": ts(s), "dur": e - s, "pid": 0, "tid": 7, "args": {"correlation": corr}})
        events.append({"ph": "s", "cat": "ac2g", "id": corr, "ts": ts(at), "pid": 1, "tid": CUPTI[tid]})
    return {"baseTimeNanoseconds": BASE_NS, "traceEvents": events}


def test_join_gives_the_device_spans_idle_by_span_and_host_times():
    out = spans.join(_trace(), TAKEN, tuple(int(us * 1e3) for us in WINDOW_US))
    ms = {k: [round(v, 9) for v in vs] for k, vs in out["span_device_ms"].items()}
    assert ms == {"train.step": [0.75], "train.forward": [0.29], "mvsnet.costreg": [0.2, 0.01],
                  "train.backward": [0.28], "sweep.backward": [0.095]}
    idle = {k: round(v * 1e6, 6) for k, v in out["idle_by_span"].items()}
    assert idle == {spans.OUTSIDE: 180.0, "mvsnet.costreg": 40.0, "train.step": 610.0, "train.backward": 45.0,
                    "sweep.backward": 50.0}
    busy = sum(e - s for *_, s, e in LAUNCHES)
    assert abs(sum(out["idle_by_span"].values()) - (WINDOW_US[1] - WINDOW_US[0] - busy) / 1e6) < 1e-9
    program = {k: {f: round(v, 9) for f, v in d.items()} for k, d in out["program_spans"].items()}
    assert program == {"train.step": {"n": 1, "ms": 1.0, "self_ms": 0.16},
                       "train.forward": {"n": 1, "ms": 0.39, "self_ms": 0.19},
                       "mvsnet.costreg": {"n": 2, "ms": 0.125, "self_ms": 0.125},
                       "train.backward": {"n": 1, "ms": 0.45, "self_ms": 0.35},
                       "sweep.backward": {"n": 1, "ms": 0.1, "self_ms": 0.1}}
    assert out["launches"] == TAKEN["launches"]


def test_reduce_trace_keys_are_the_same_with_the_spans(tmp_path):
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump(_trace(), f)
    plain = reduce_trace(path, 1.4e-3)
    joined = spans.reduce_with_spans(path, 1.4e-3, TAKEN, int(WINDOW_US[0] * 1e3))
    assert {k: joined[k] for k in plain} == plain
    assert set(joined) - set(plain) == {"span_device_ms", "idle_by_span", "program_spans", "launches"}
    assert abs(sum(joined["idle_by_span"].values()) - (plain["window_s"] - plain["busy_s"])) < 1e-9


RECORD = {"requests": 4, "steps": 2, "trace": {
    "span_device_ms": {"mvsnet.costreg": [30.0, 40.0], "sweep.backward": [8.0, 9.0]},
    "program_spans": {"infer.h2d": {"n": 4, "ms": 1.5, "self_ms": 1.5}, "feed.wait": {"n": 3, "ms": 0.2, "self_ms": 0.2}},
    "launches": {"sweep_variance": 4, "softmax_regression": 4, "sweep_variance_emit": 0}}}
EXPECTED = {"h2d_ms.request": 1.5, "costreg_span_ms.request": 35.0, "kernel_launches.request": 2.0,
            "feed_wait_ms.train": 0.3, "costreg_fwd_span_ms.train": 35.0, "sweep_bwd_span_ms.train": 8.5,
            "kernel_launches.train": 4.0}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_span_reader(name):
    read = manifest.reader(name)
    assert read(RECORD) == pytest.approx(EXPECTED[name], rel=1e-12)
    assert read({}) is None and read({"requests": 4, "steps": 2, "trace": None}) is None
    assert read({"requests": 4, "steps": 2, "trace": {"busy_s": 1.0, "window_s": 2.0}}) is None


def test_span_run_names_a_reader_for_each_metric_and_needs_a_card():
    names = [n for kind in span_run.SPAN_METRICS.values() for n in kind]
    assert sorted(names) == sorted(EXPECTED)
    out = subprocess.run([sys.executable, "mvsbench/span_run.py", "--workload", "dtu_request", "--seed",
                          "2147483999", "--seconds", "1"], cwd=manifest.CHECKOUT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout and "CUDA" in out.stderr
