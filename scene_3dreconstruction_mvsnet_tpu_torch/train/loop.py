"""Training and testing loop.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/train/loop.py::Trainer``
(the reference's epoch structure, ``train.py:157-238``): a train step per
batch with scalar summaries every ``summary_freq`` steps, a checkpoint every
``save_freq`` epochs, and a full test pass per epoch averaged over its
batches. Batches come from the JAX package's framework-free loader
(``data/pipeline.py``, numpy only), with images packed to u8 in the producer
thread and divided by 255 on the device. Scalars go to
``<logdir>/scalars.jsonl``, one JSON object per summary.

Not ported: the paired-sweep plan check (``plan_valid``, ``--plan_check``,
``--env_samples``), which exists because the TPU kernels have static window
envelopes, and the profile mode and ``--debug_MVSnet`` dumps (ROADMAP).
"""

from __future__ import annotations

import json
import os
import time

import torch
import torch.nn as nn

from scene_3dreconstruction_mvsnet_tpu.data.pipeline import BackgroundLoader, Loader, pack_u8_imgs

from .checkpoint import find_latest, load_model, restore_checkpoint, save_checkpoint
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
        device: torch.device | str = "cuda",
    ) -> None:
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.logdir = logdir
        self.epochs = epochs
        self.summary_freq = summary_freq
        self.save_freq = save_freq
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

    def _log(self, mode: str, values: dict[str, float], step: int) -> None:
        rec = {"mode": mode, "step": int(step), "time": time.time(), **values}
        with open(os.path.join(self.logdir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

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
                    self._log("train", values, self.global_step)
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
            self._log("fulltest", final_test, self.global_step)
            print("avg_test_scalars:", final_test)
        return final_test

    def test(self) -> dict[str, float]:
        totals: dict[str, float] = {}
        count = 0
        for batch_idx, batch in enumerate(BackgroundLoader(self.test_loader, transform=pack_u8_imgs)):
            values = scalars(self.eval_step(batch))
            if self.global_step % self.summary_freq == 0 and batch_idx == 0:
                self._log("test", values, self.global_step)
            for k, v in values.items():
                totals[k] = totals.get(k, 0.0) + v
            count += 1
        return {k: v / count for k, v in totals.items()}
