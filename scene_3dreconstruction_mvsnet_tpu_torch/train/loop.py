"""Training, testing and profiling loops.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/train/loop.py::Trainer``
(the reference's epoch structure, ``train.py:157-238``): a train step per
batch with scalar and image summaries every ``summary_freq`` steps, a
checkpoint every ``save_freq`` epochs, and a full test pass per epoch
averaged over its batches. Batches come from the port's loader
(``data/pipeline.py``, numpy only), with images packed to u8 in the producer
thread and divided by 255 on the device. Summaries go through
``train/logging.py::SummaryLogger`` (``<logdir>/scalars.jsonl``, and
TensorBoard where ``tensorboardX`` imports); ``debug_mvsnet`` adds the
``--debug_MVSnet`` stage dumps at the summary cadence. ``profile`` traces
eval steps with ``torch.profiler`` into a Chrome trace, the reference's
``train.py:361-389`` export.

Not ported: the paired-sweep plan check (``plan_valid``, ``--plan_check``,
``--env_samples``), which exists because the TPU kernels have static window
envelopes.
"""

from __future__ import annotations

import os
import time
from typing import Any

import numpy as np
import torch
import torch.nn as nn

from ..data.pipeline import BackgroundLoader, Loader, pack_u8_imgs
from ..utils.debug_dump import debug_forward
from .checkpoint import find_latest, load_model, restore_checkpoint, save_checkpoint
from .logging import SummaryLogger
from .lr import make_scheduler
from .state import make_eval_step, make_optimizer, make_train_step

SCALAR_KEYS = (
    "loss",
    "abs_depth_error",
    "thres1mm_error",
    "thres2mm_error",
    "thres4mm_error",
    "thres8mm_error",
)


def scalars(aux: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(aux[k]) for k in SCALAR_KEYS if k in aux}


def images(aux: dict[str, torch.Tensor], batch: dict) -> dict[str, np.ndarray]:
    """The image summaries of a step, for the batch's first sample, on the
    host: the JAX Trainer's ``_images`` (u8 reference images divided by
    255). The JAX logger is handed the [B, h, w] maps whole and reads them
    as channels-first images, so B samples become B channels, and B > 4
    fails; the port hands over the first sample, which the logger shows."""
    depth_est = aux["depth_est"][0].float().cpu().numpy()
    mask = np.asarray(batch["mask"][0])
    depth_gt = np.asarray(batch["depth"][0])
    ref_img = np.asarray(batch["imgs"][0, 0])
    if ref_img.dtype == np.uint8:
        ref_img = ref_img.astype(np.float32) / 255.0
    return {
        "depth_est": depth_est * mask,
        "depth_gt": depth_gt,
        "ref_img": ref_img,
        "mask": mask,
        "errormap": np.abs(depth_est - depth_gt) * mask,
        "photo_conf": aux["photometric_confidence"][0].float().cpu().numpy(),
    }


class Trainer:
    """Owns the model, optimizer, scheduler and loaders, and runs the epoch
    loop on ``device``."""

    def __init__(
        self,
        model: nn.Module,
        train_dataset,
        test_dataset,
        *,
        logdir: str,
        epochs: int = 16,
        lr: float = 1e-3,
        lrepochs: str = "10,12,14:2",
        weight_decay: float = 0.0,
        batch_size: int = 1,
        summary_freq: int = 100,
        save_freq: int = 1,
        seed: int = 1,
        num_workers: int = 4,
        debug_mvsnet: int = 0,
        device: torch.device | str = "cuda",
    ) -> None:
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.logdir = logdir
        self.epochs = epochs
        self.summary_freq = summary_freq
        self.save_freq = save_freq
        # --debug_MVSnet bitmask: each summary step dumps the selected forward
        # stages under <logdir>/debug_train/step<N>/debug/ (utils/debug_dump.py)
        self.debug_mvsnet = int(debug_mvsnet)
        os.makedirs(logdir, exist_ok=True)

        self.train_loader = Loader(
            train_dataset, batch_size, shuffle=True, drop_last=True, num_workers=num_workers, seed=seed,
        )
        self.test_loader = Loader(test_dataset, batch_size, shuffle=False, drop_last=False, num_workers=num_workers)

        self.optimizer = make_optimizer(self.model, lr, weight_decay)
        self.scheduler = make_scheduler(self.optimizer, lrepochs, max(len(self.train_loader), 1))
        self.train_step = make_train_step(self.model, self.optimizer, self.scheduler, self.device)
        self.eval_step = make_eval_step(self.model, self.device)
        self.start_epoch = 0
        self.global_step = 0
        self.logger = SummaryLogger(logdir)

    # -- checkpointing ------------------------------------------------------
    def resume(self) -> bool:
        latest = find_latest(self.logdir)
        if latest is None:
            return False
        self.start_epoch = restore_checkpoint(latest, self.model, self.optimizer, self.scheduler)
        self.global_step = self.scheduler.last_epoch
        print(f"Resuming from {latest} at epoch {self.start_epoch}")
        return True

    def load(self, path: str) -> None:
        load_model(path, self.model)

    # -- loops ---------------------------------------------------------------
    def train(self) -> dict[str, float]:
        final_test: dict[str, float] = {}
        for epoch in range(self.start_epoch, self.epochs):
            print(f"Epoch {epoch}:")
            t_epoch = time.time()
            n_samples = 0
            steps = len(self.train_loader)
            for batch_idx, batch in enumerate(BackgroundLoader(self.train_loader, transform=pack_u8_imgs)):
                t0 = time.time()
                lr_now = self.optimizer.param_groups[0]["lr"]
                n_samples += int(batch["imgs"].shape[0])
                aux = self.train_step(batch)
                if self.global_step % self.summary_freq == 0:
                    values = scalars(aux)
                    self.logger.save_scalars("train", values, self.global_step)
                    self.logger.save_images("train", images(aux, batch), self.global_step)
                    if self.debug_mvsnet:
                        debug_forward(self.model, batch["imgs"], batch["proj_matrices"], batch["depth_values"],
                                      self.debug_mvsnet,
                                      os.path.join(self.logdir, "debug_train", f"step{self.global_step:06d}"))
                    msg = ", ".join(f"{k}={v:.3f}" for k, v in values.items())
                    print(f"Epoch {epoch}/{self.epochs}, Iter {batch_idx}/{steps}, "
                          f"LR:{lr_now:.2E}, {msg}, time={time.time() - t0:.3f}")
                self.global_step += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt_epoch = time.time() - t_epoch
            print(f"epoch {epoch} train wall: {dt_epoch:.2f}s ({n_samples} samples, "
                  f"{n_samples / max(dt_epoch, 1e-9):.3f} samples/s end-to-end)")

            if (epoch + 1) % self.save_freq == 0:
                print(f"Saved checkpoint {save_checkpoint(self.logdir, epoch, self.model, self.optimizer)}")

            final_test = self.test()
            self.logger.save_scalars("fulltest", final_test, self.global_step)
            print("avg_test_scalars:", final_test)
        return final_test

    def test(self) -> dict[str, float]:
        totals: dict[str, float] = {}
        count = 0
        for batch_idx, batch in enumerate(BackgroundLoader(self.test_loader, transform=pack_u8_imgs)):
            aux = self.eval_step(batch)
            values = scalars(aux)
            if self.global_step % self.summary_freq == 0 and batch_idx == 0:
                self.logger.save_scalars("test", values, self.global_step)
                self.logger.save_images("test", images(aux, batch), self.global_step)
            for k, v in values.items():
                totals[k] = totals.get(k, 0.0) + v
            count += 1
        return {k: v / count for k, v in totals.items()}

    def profile(self, warmup_iters: int = 5, profile_iters: int = 5) -> str:
        """Warm up with ``warmup_iters`` eval steps, then trace
        ``profile_iters`` more with ``torch.profiler`` (CPU activity, and
        CUDA activity on the card), printing each iteration's time. Writes
        ``<logdir>/profile/trace.json`` (Chrome trace format) and returns its
        path."""
        from torch.profiler import ProfilerActivity, profile

        batches: list[Any] = []
        it = iter(self.test_loader)
        for _ in range(max(warmup_iters, profile_iters)):
            try:
                batches.append(next(it))
            except StopIteration:
                it = iter(self.test_loader)
                batches.append(next(it))

        def one(batch) -> None:
            float(self.eval_step(batch)["loss"])  # waits for the step

        for i in range(warmup_iters):
            t0 = time.time()
            one(batches[i % len(batches)])
            print(f"WarmUp Iter {i}, time = {time.time() - t0:.4f}")

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        with profile(activities=activities) as prof:
            for i in range(profile_iters):
                t0 = time.time()
                one(batches[i % len(batches)])
                print(f"Profile Iter {i}, time = {time.time() - t0:.4f}")
        trace_dir = os.path.join(self.logdir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"Profiler trace written to {path}")
        return path
