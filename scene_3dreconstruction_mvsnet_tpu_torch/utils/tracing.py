"""Spans of the port's own work on the host clock, for traced runs.

Off by default. ``enable()`` starts recording, ``take()`` returns what was
recorded and empties the buffer, ``disable()`` stops. While off,
``span(name)`` costs one test of a module global and returns one shared null
context: no clock read, no allocation, no lock.

A span records its name, its start and end (``time.perf_counter_ns``), the
index of its parent, its thread's two ids and an item id. The thread's
native id (``threading.get_native_id``) is the ``tid`` of its CPU operations
in torch.profiler's exported trace; its pthread id (``threading.get_ident``),
cut to 32 bits, is the ``tid`` that CUPTI gives its CUDA runtime calls
there, the kernel launches among them. The parent is the innermost span open
on the same thread or, where that thread has none open, the innermost span
open on any thread: on a card the autograd engine runs a Function's backward
on a thread of its own, below the caller's ``loss.backward()``. The item id
is the index of the outermost ancestor, so the spans of one request or one
train step share it.

``take()`` also returns ``offset_ns``, which puts every stamp on Unix time in
ns. That is the clock of torch.profiler's exported trace: an event's ``ts``
(µs) plus the trace's ``baseTimeNanoseconds`` / 1e3. It returns the
hand-written kernels' launch counts too (``ops.kernels.launch_counts``, the
port's one set of counters). Whoever reads the spans joins them with the
device's work (``mvsbench/spans.py``): the tracer itself records no CUDA
event, calls neither ``record_function`` nor NVTX, never synchronises and
writes nothing.

The spans, each opened where its work is done:

  infer              ``infer.py::make_infer_step``'s ``infer``, the whole call
  infer.h2d          its copies to the device and the u8 -> f32 divide
  mvsnet.costreg     ``MVSNet``'s CostRegNet call (with ``--remat`` it opens
                     again inside ``train.backward``: the recompute)
  train.step         ``train/state.py::make_train_step``'s ``train_step``
  train.forward      the model and the loss
  train.backward     ``loss.backward()`` and the gradients' reduction
  train.optimizer    ``optimizer.step()`` and ``scheduler.step()``
  sweep.backward     ``ops/paired_sweep.py::PairedCostVolume.backward``
  deconv.parity      ``models/blocks.py::conv_transpose3d_k3s2``, the stride-2
                     transposed conv by output parity: the decoder's three in
                     CostRegNet's forward, and the stride-2 convs' three input
                     gradients in the backward (on the autograd thread)
  costreg.to_ndhwc   ``models/blocks.py::to_ndhwc``: a 3D block's input copied
                     to NDHWC because it came in another layout (the fallback;
                     none on the cells' paths, whose activations are NDHWC
                     from the sweep's volume to ``prob``)
  feed.wait          ``data/pipeline.py::prefetch_to_device``: the consumer
                     waiting for and handed the next batch
  casmvsnet.fpn      ``models/cas_mvsnet.py::CasMVSNet``'s feature pyramid
  casmvsnet.stage{s} its stage s (1, 2, 3) whole: the stage's projections and
                     depth planes, and the three spans below
  casmvsnet.sweep{s} the stage's K1 call (per-pixel planes from stage 2 on)
  casmvsnet.costreg{s}  the stage's CostRegNet
  casmvsnet.regress{s}  the stage's K2 call
  rmvsnet.features   ``models/rmvsnet.py::RMVSNet``'s FeatureNet call
  rmvsnet.recurrence its recurrent regulariser over every plane: the K1
                     chunks, the 32 -> 16 conv, the three GRU cells and the
                     logit conv a plane
  rmvsnet.sweep      inside it, each chunk's K1 call (``PLANE_CHUNK`` planes)
  rmvsnet.regress    the winner-take-all pass over the logit maps
"""

from __future__ import annotations

import contextlib
import threading
import time

_on = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_spans: list[list] = []  # [name, start_ns, end_ns, parent, tid, ident, item]
_open: dict[int, list[int]] = {}  # native thread id -> indices of its open spans, innermost last
_offset_ns = 0


class _Span:
    """One span while the tracer is on; records itself on entry and exit."""

    __slots__ = ("name", "record", "tid")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        tid = threading.get_native_id()
        with _lock:
            stack = _open.setdefault(tid, [])
            # innermost open span: this thread's, else the latest opened on any thread
            parent = stack[-1] if stack else max((s[-1] for s in _open.values() if s), default=None)
            index = len(_spans)
            item = index if parent is None else _spans[parent][6]
            self.record = [self.name, time.perf_counter_ns(), None, parent, tid, threading.get_ident(), item]
            self.tid = tid
            _spans.append(self.record)
            stack.append(index)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        with _lock:
            self.record[2] = end
            stack = _open.get(self.tid)
            if stack and _spans[stack[-1]] is self.record:  # not so where take() ran while it was open
                stack.pop()
        return False


def span(name: str):
    """A context manager that records ``name``'s span while the tracer is
    on, and the shared null context while it is off."""
    if not _on:
        return _NULL
    return _Span(name)


def enable() -> None:
    """Empty the buffer, take the clock pair that fixes ``offset_ns`` and
    start recording."""
    global _on, _offset_ns
    with _lock:
        _spans.clear()
        _open.clear()
        _offset_ns = time.time_ns() - time.perf_counter_ns()
        _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clock_offset_ns() -> int:
    """Unix time minus ``time.perf_counter_ns``, from ``enable()``'s pair."""
    return _offset_ns


def take() -> dict:
    """The spans recorded since ``enable()`` or the last ``take()``, the
    buffer emptied -> {'spans': [{'name', 'start_ns', 'end_ns', 'parent',
    'tid', 'ident', 'item'}] (a span still open has ``end_ns`` None and is not
    recorded further), 'offset_ns', 'launches'}. ``parent`` and ``item``
    index the returned list."""
    from ..ops.kernels import launch_counts

    global _spans
    with _lock:
        spans, _spans = _spans, []
        _open.clear()
    keys = ("name", "start_ns", "end_ns", "parent", "tid", "ident", "item")
    return {"spans": [dict(zip(keys, s)) for s in spans], "offset_ns": _offset_ns, "launches": launch_counts()}
