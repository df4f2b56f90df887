"""The port's span tracer (``utils/tracing.py``) on the CPU: off, the spans
of a request, a train step and the feed record nothing and read no clock;
on, they form the tree the tracer documents, one item id per request or
step; the backward of the paired sweep run on another thread hangs below
the span open on the caller's thread; the stamps share torch.profiler's
clock and thread ids; and the tracer touches no CUDA event, profiler range
or NVTX."""

import ast
import inspect
import json
import threading
import time

import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu_torch.data import Loader, prefetch_to_device
from scene_3dreconstruction_mvsnet_tpu_torch.data.synthetic import SyntheticRig
from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import KERNEL_NAMES
from scene_3dreconstruction_mvsnet_tpu_torch.ops.paired_sweep import PairedCostVolume
from scene_3dreconstruction_mvsnet_tpu_torch.train import make_optimizer, make_scheduler, make_train_step
from scene_3dreconstruction_mvsnet_tpu_torch.utils import tracing

torch.set_num_threads(1)

V, HW, D = 3, (32, 32), 16


def _sample(i: int) -> dict:
    """One sample of a 3-view 32x32 plane rig with 16 planes, u8 images:
    imgs [V, H, W, 3], proj_matrices [V, 4, 4] (intrinsics / 4), depth_values
    [D], depth and mask [H/4, W/4]."""
    rig = SyntheticRig(n_views=V, img_hw=HW, baseline=4.0 + i)
    imgs = np.stack([rig.render(v) for v in range(V)])
    proj = []
    for v in range(V):
        k = np.eye(4, dtype=np.float32)
        k[:3, :3] = rig.K
        k[:2] /= 4.0
        proj.append(k @ rig.extrinsics(v))
    lo, hi = rig.depth_range()
    return {"imgs": np.rint(imgs * 255.0).astype(np.uint8), "proj_matrices": np.stack(proj).astype(np.float32),
            "depth_values": np.linspace(lo - 2.0, hi + 2.0, D, dtype=np.float32),
            "depth": rig.depth_map(0, scale=4), "mask": np.ones((HW[0] // 4, HW[1] // 4), np.float32)}


class Samples:
    def __len__(self) -> int:
        return 4

    def __getitem__(self, i: int) -> dict:
        return _sample(i)


def _model(remat: bool = False) -> MVSNet:
    return random_init_(MVSNet(remat=remat), torch.Generator().manual_seed(0))


def _request():
    s = _sample(0)
    return tuple(torch.from_numpy(s[k][None]) for k in ("imgs", "proj_matrices", "depth_values"))


def _step(model: MVSNet):
    opt = make_optimizer(model, 1e-3)
    return make_train_step(model, opt, make_scheduler(opt, "10:2", 100), "cpu")


@pytest.fixture
def tracer():
    """The tracer on, and off again after the test whatever it did."""
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.take()


def test_off_records_nothing_reads_no_clock_and_allocates_no_span(monkeypatch):
    tracing.disable()
    tracing.take()

    def no_clock():
        raise AssertionError("the tracer read the clock while off")

    infer = make_infer_step(_model(), "cpu")
    step = _step(_model())
    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert tracing.span("infer") is tracing.span("train.step")  # one shared null context
    infer(*_request())
    batches = prefetch_to_device(Loader(Samples(), batch_size=2), "cpu")
    for _, batch in batches:
        step(batch)
    monkeypatch.undo()
    out = tracing.take()
    assert not tracing.enabled() and out["spans"] == []


def _by_name(spans: list[dict]) -> dict[str, list[int]]:
    out: dict[str, list[int]] = {}
    for i, s in enumerate(spans):
        out.setdefault(s["name"], []).append(i)
    return out


def test_a_request_is_one_tree_with_one_item_id(tracer):
    infer = make_infer_step(_model(), "cpu")
    infer(*_request())
    infer(*_request())
    spans = tracer.take()["spans"]
    names = _by_name(spans)
    assert [s["name"] for s in spans] == ["infer", "infer.h2d", "mvsnet.costreg", *["deconv.parity"] * 3] * 2
    for k in names["deconv.parity"]:  # the decoder's three transposed convs
        assert spans[spans[k]["parent"]]["name"] == "mvsnet.costreg"
    for root in names["infer"]:
        assert spans[root]["parent"] is None and spans[root]["item"] == root
        kids = [s for s in spans if s["parent"] == root]
        assert [s["name"] for s in kids] == ["infer.h2d", "mvsnet.costreg"]
        assert all(s["item"] == root and s["tid"] == threading.get_native_id() for s in kids)
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]


@pytest.mark.parametrize("remat", [False, True])
def test_a_fed_train_step_is_one_tree_with_one_item_id(tracer, remat):
    """The feed's wait, then the step: forward (CostRegNet in it, the
    decoder's three transposed convs in that), backward (the stride-2 convs'
    three input gradients and the paired sweep's backward in it: on the CPU
    the autograd engine runs them on the calling thread; with remat
    CostRegNet's recompute too, its decoder in it) and the optimizer."""
    step = _step(_model(remat))
    batches = prefetch_to_device(Loader(Samples(), batch_size=2), "cpu")
    _, batch = next(batches)
    step(batch)
    batches.close()
    out = tracer.take()
    spans = out["spans"]
    pairs = [(s["name"], None if s["parent"] is None else spans[s["parent"]]["name"]) for s in spans]
    decoder = [("deconv.parity", "mvsnet.costreg")] * 3
    assert pairs == [("feed.wait", None), ("train.step", None), ("train.forward", "train.step"),
                     ("mvsnet.costreg", "train.forward"), *decoder, ("train.backward", "train.step"),
                     *([("mvsnet.costreg", "train.backward"), *decoder] if remat else []),
                     *[("deconv.parity", "train.backward")] * 3,
                     ("sweep.backward", "train.backward"), ("train.optimizer", "train.step")]
    assert spans[0]["item"] == 0 and {s["item"] for s in spans[1:]} == {1}
    assert {(s["tid"], s["ident"]) for s in spans} == {(threading.get_native_id(), threading.get_ident())}
    assert set(out["launches"]) == set(KERNEL_NAMES)


@pytest.mark.parametrize("remat", [False, True])
def test_deconv_parity_spans_a_step(tracer, remat):
    """``deconv.parity`` opens 6 times a train step (the decoder's three
    transposed convs, the stride-2 convs' three input gradients) and 9 times
    with remat (the recompute's decoder again); a request opens it 3 times."""
    step = _step(_model(remat))
    batches = prefetch_to_device(Loader(Samples(), batch_size=2), "cpu")
    step(next(batches)[1])
    batches.close()
    spans = tracer.take()["spans"]
    assert len(_by_name(spans)["deconv.parity"]) == (9 if remat else 6)
    make_infer_step(_model(remat), "cpu")(*_request())
    assert len(_by_name(tracer.take()["spans"])["deconv.parity"]) == 3


def test_the_sweep_backward_on_another_thread_hangs_below_the_open_span(tracer):
    """On a card the autograd engine runs PairedCostVolume.backward on a
    device thread; the CPU runs it on the caller's. So the backward runs
    here on a thread of its own while ``train.backward`` is open on this
    one: its span's parent is that span, its thread the other."""
    s = _sample(0)
    feats = torch.randn(1, V, 8, 8, 4, requires_grad=True)
    proj, depth = torch.from_numpy(s["proj_matrices"][None]), torch.from_numpy(s["depth_values"][None])
    tids = []

    def backward():
        tids.append((threading.get_native_id(), threading.get_ident()))
        PairedCostVolume.apply(feats, proj, depth, torch.float32, None).square().sum().backward()

    with tracing.span("train.backward"):
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join(timeout=120)
    assert not worker.is_alive() and feats.grad is not None
    spans = tracer.take()["spans"]
    assert [s["name"] for s in spans] == ["train.backward", "sweep.backward"]
    assert spans[1]["parent"] == 0 and spans[1]["item"] == 0
    assert (spans[1]["tid"], spans[1]["ident"]) == tids[0] and spans[1]["tid"] != spans[0]["tid"]


def test_nested_spans_on_threads_and_take(tracer):
    """The innermost span of the thread is the parent; a thread with none
    open takes the latest opened anywhere; take() empties the buffer, and a
    span open across it is returned unfinished and not recorded again."""
    with tracing.span("a"):
        with tracing.span("b"):
            t = threading.Thread(target=lambda: tracing.span("c").__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=30)
        with tracing.span("d"):
            pass
    with tracing.span("e"):
        out = tracer.take()
    assert [(s["name"], s["parent"], s["item"]) for s in out["spans"]] == [
        ("a", None, 0), ("b", 0, 0), ("c", 1, 0), ("d", 0, 0), ("e", None, 4)]
    assert out["spans"][4]["end_ns"] is None
    assert tracer.take()["spans"] == []
    with tracing.span("f"):
        pass
    assert [(s["name"], s["parent"]) for s in tracer.take()["spans"]] == [("f", None)]


def test_stamps_share_the_profiler_clock_and_thread_ids(tracer, tmp_path):
    """A CPU op recorded by torch.profiler inside a span lies inside the
    span's interval once both are on Unix time (span: + offset_ns; trace:
    ts + baseTimeNanoseconds / 1e3), within 1 ms, on the span's thread."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.01)
        with tracing.span("infer"):
            time.sleep(0.01)
            torch.mm(a, a)
            time.sleep(0.01)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    out = tracer.take()
    (s,) = out["spans"]
    assert out["offset_ns"] == tracing.clock_offset_ns()
    start, end = ((s[k] + out["offset_ns"]) / 1e3 for k in ("start_ns", "end_ns"))
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    (op,) = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    t0 = float(op["ts"]) + base
    assert start - 1e3 <= t0 and t0 + float(op["dur"]) <= end + 1e3, (start, t0, end)
    assert end - start < 1e6
    assert int(op["tid"]) == s["tid"]


def test_the_tracer_touches_no_cuda_event_profiler_range_or_file():
    tree = ast.parse(inspect.getsource(tracing))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.name for a in node.names} | {getattr(node, "module", None) or ""}
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.Name):
            names.add(node.id)
    found = {n for n in names for bad in ("cuda", "record_function", "nvtx", "synchronize", "Event", "profiler")
             if bad in n}
    assert not found and not names & {"open", "print", "torch"}, found
