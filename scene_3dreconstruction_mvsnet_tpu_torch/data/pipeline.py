"""Host input pipeline: batching, shuffling and threaded decode.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/data/pipeline.py``, with
the same batches in the same order for the same seed. Samples are decoded on
host threads (Pillow and numpy release the GIL for the heavy parts), stacked
into numpy batches, and a producer thread keeps the next batches ready while
the device computes. ``prefetch_to_device`` also stages each batch in
reused pinned buffers on that thread and copies it to the card on a side
stream, a batch ahead of the step.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ..parallel.sharding import shard_rows
from ..utils import tracing

PREFETCH_DEPTH = 2  # batches in flight to the card: the one handed over and the next
STAGING_SLOTS = 3  # pinned buffer sets; any number works, more let the producer run further ahead


def _collate(samples: list[dict]) -> dict:
    """Stack sample dicts into a batch dict; fields that are not arrays or
    numbers (the filename template, the scan) become lists."""
    out: dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.floating, np.integer)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class Loader:
    """Map-style loader: ``batch_size`` samples per batch, reshuffled per
    epoch from ``seed`` when ``shuffle``, the trailing partial batch dropped
    when ``drop_last``; ``num_workers`` > 0 decodes on a thread pool with a
    bounded lookahead, 0 inline.

    ``shard=(rank, world)``: every rank walks the same batches (the same
    seed) and decodes only its share: rows [r B/W, (r+1) B/W) of each batch
    (``batch_size`` must divide by ``world``; the trailing partial batch is
    dropped), or with ``shard_batches`` every ``world``-th whole batch from
    the ``rank``-th."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 0, seed: int = 0, shard: tuple[int, int] | None = None,
                 shard_batches: bool = False) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self._rng = np.random.RandomState(seed)
        self.shard = shard
        self.shard_batches = shard_batches
        if shard is not None and not shard_batches:
            shard_rows(batch_size, *shard)  # the batch must divide by the world size
            self.drop_last = True

    def __len__(self) -> int:
        n = len(self.dataset)
        batches = n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size
        if self.shard is not None and self.shard_batches:
            rank, world = self.shard
            return len(range(rank, batches, world))
        return batches

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        n = len(order)
        ends = n - (n % self.batch_size) if self.drop_last else n
        batches = [order[i : i + self.batch_size] for i in range(0, ends, self.batch_size)]
        if self.shard is not None:
            rank, world = self.shard
            if self.shard_batches:
                batches = batches[rank::world]
            else:
                batches = [idxs[shard_rows(len(idxs), rank, world)] for idxs in batches]
        if not batches:
            return
        if self.num_workers <= 0:
            for idxs in batches:
                yield _collate([self.dataset[int(i)] for i in idxs])
            return
        # about two batches of samples in flight
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            flat = iter([int(i) for idxs in batches for i in idxs])
            futures = collections.deque(
                pool.submit(self.dataset.__getitem__, i)
                for _, i in zip(range(max(2 * self.batch_size, self.num_workers)), flat)
            )
            for idxs in batches:
                done = []
                while len(done) < len(idxs):
                    done.append(futures.popleft().result())
                    nxt = next(flat, None)
                    if nxt is not None:
                        futures.append(pool.submit(self.dataset.__getitem__, nxt))
                yield _collate(done)


def pack_u8_imgs(batch: dict) -> dict:
    """Replace float32 ``imgs`` by their u8 form when they are exactly u8/255
    (Pillow decodes and resizes in u8), a quarter of the bytes to copy to
    the device, which divides by 255 again; other images are left as they
    are. Runs in the producer thread."""
    imgs = batch.get("imgs")
    if isinstance(imgs, np.ndarray) and imgs.dtype == np.float32:
        u8 = np.rint(imgs * 255.0).astype(np.uint8)
        if np.array_equal(u8.astype(np.float32) / 255.0, imgs):
            batch["imgs"] = u8
    return batch


class BackgroundLoader:
    """Iterate a Loader on a producer thread, at most ``max_queue`` batches
    ahead; ``transform`` is applied to each batch on that thread. An error in
    the producer is raised in the consumer."""

    def __init__(self, loader: Loader, max_queue: int = 2, transform=None) -> None:
        self.loader = loader
        self.max_queue = max_queue
        self.transform = transform

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        sentinel = object()
        q: collections.deque = collections.deque()
        cond = threading.Condition()
        err: list[BaseException] = []

        def produce():
            try:
                for batch in self.loader:
                    if self.transform is not None:
                        batch = self.transform(batch)
                    with cond:
                        while len(q) >= self.max_queue:
                            cond.wait()
                        q.append(batch)
                        cond.notify_all()
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                with cond:
                    q.append(sentinel)
                    cond.notify_all()

        threading.Thread(target=produce, daemon=True).start()
        while True:
            with cond:
                while not q:
                    cond.wait()
                item = q.popleft()
                cond.notify_all()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item


class PinnedStaging:
    """A ring of STAGING_SLOTS sets of pinned host buffers, one tensor per
    batch field, reused from batch to batch (a buffer is allocated again only
    when a field's shape or dtype changes). ``pin`` (the producer thread)
    takes a free slot, waits for the copy that last read it, and copies the
    batch's arrays in; ``release`` (the consumer) returns the slot with the
    event that marks the end of its copy to the card."""

    def __init__(self) -> None:
        self._buffers: list[dict[str, torch.Tensor]] = [{} for _ in range(STAGING_SLOTS)]
        self._free: queue.Queue = queue.Queue()
        for slot in range(STAGING_SLOTS):
            self._free.put((slot, None))

    def pin(self, batch: dict) -> tuple[int, dict, dict[str, torch.Tensor]]:
        """-> (slot, the host batch, its arrays in the slot's pinned buffers)."""
        slot, copied = self._free.get()
        if copied is not None:
            copied.synchronize()
        buffers, pinned = self._buffers[slot], {}
        for key, value in batch.items():
            if isinstance(value, np.ndarray):
                src = torch.from_numpy(np.ascontiguousarray(value))
                buf = buffers.get(key)
                if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                    buf = buffers[key] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                pinned[key] = buf.copy_(src)
        return slot, batch, pinned

    def release(self, slot: int, copied) -> None:
        self._free.put((slot, copied))


def prefetch_to_device(loader: Iterable[dict], device: torch.device | str,
                       transform: Callable[[dict], dict] | None = None) -> Iterator[tuple[dict, dict]]:
    """Iterate ``loader`` (a ``Loader``) on a producer thread and yield
    ``(host batch, device batch)``: the device batch holds every numpy array
    of the host batch as a tensor on ``device``; other fields stay in the
    host batch. ``transform`` runs on the producer thread first.

    On a card the producer stages each batch in reused pinned buffers
    (``PinnedStaging``), and the copy to the card is issued ``non_blocking``
    on a side stream as soon as the batch is ready, a batch ahead of the one
    yielded (PREFETCH_DEPTH); the consuming stream waits on the copy's event
    before it is handed the batch. The counterpart of the JAX package's
    ``prefetch_to_device``. Elsewhere the arrays are wrapped as CPU tensors.

    Each wait of the consumer for its next batch, up to the batch being
    handed over, is the ``feed.wait`` span (``utils/tracing.py``)."""
    device = torch.device(device)
    if device.type != "cuda":
        batches = iter(BackgroundLoader(loader, transform=transform))
        while True:
            with tracing.span("feed.wait"):
                batch = next(batches, None)
                if batch is None:
                    return
                on_device = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
            yield batch, on_device

    staging = PinnedStaging()
    side = torch.cuda.Stream(device)

    def produce(batch: dict):
        return staging.pin(transform(batch) if transform is not None else batch)

    def issue(item):
        slot, host, pinned = item
        with torch.cuda.stream(side):
            on_device = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
            copied = torch.cuda.Event()
            copied.record(side)
        staging.release(slot, copied)
        return host, on_device, copied

    def hand_over(host, on_device, copied):
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(copied)
        for t in on_device.values():
            t.record_stream(consumer)  # allocated on the side stream, used on this one
        return host, on_device

    issued: collections.deque = collections.deque()
    items = iter(BackgroundLoader(loader, transform=produce))
    while True:
        with tracing.span("feed.wait"):
            while len(issued) < PREFETCH_DEPTH:
                item = next(items, None)
                if item is None:
                    break
                issued.append(issue(item))
            if not issued:
                return
            batch = hand_over(*issued.popleft())
        yield batch
