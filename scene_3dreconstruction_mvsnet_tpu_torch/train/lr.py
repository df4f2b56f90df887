"""Learning-rate schedule: the reference's MultiStepLR DSL, per step.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/train/lr.py``, written
anew because that package's ``train`` imports JAX. ``--lrepochs
"10,12,14:2"`` lists milestone epochs before the colon and the LR divisor
after it. Epoch e trains with lr0 / divisor^(number of milestones <= e),
applied from the step that starts the milestone epoch (the JAX package's
standard semantics, not the reference's legacy scheduler-before-optimizer
order).
"""

from __future__ import annotations

from typing import Callable

import torch


def parse_lrepochs(spec: str) -> tuple[list[int], float]:
    """'10,12,14:2' -> ([10, 12, 14], 0.5) (milestones, gamma)."""
    milestones_str, divisor_str = spec.split(":")
    milestones = [int(e) for e in milestones_str.split(",") if e]
    return milestones, 1.0 / float(divisor_str)


def multistep_factor(lrepochs: str, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> gamma^(number of milestone steps <= step)."""
    milestones, gamma = parse_lrepochs(lrepochs)
    boundaries = sorted(m * steps_per_epoch for m in milestones)
    return lambda step: gamma ** sum(step >= b for b in boundaries)


def make_scheduler(
    optimizer: torch.optim.Optimizer, lrepochs: str, steps_per_epoch: int
) -> torch.optim.lr_scheduler.LambdaLR:
    """A scheduler stepped once per optimizer step: after k steps the
    optimizer's lr is its base lr times ``multistep_factor(k)``."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, multistep_factor(lrepochs, steps_per_epoch))
