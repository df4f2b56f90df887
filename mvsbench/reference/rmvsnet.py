"""R-MVSNet in plain PyTorch and float32: the benchmark's reference for the
recurrent regulariser, and the tier-1 tests' too.

Written from Yao et al. 2019 (arXiv:1902.10556, §3.3) with nothing of the
port: MVSNet's FeatureNet and variance sweep (``reference/mvsnet.py``:
``F.grid_sample`` of each source view onto a plane, the variance over the
views), then, plane by plane in order of increasing depth, a 3x3 conv of the
32-channel cost map C(t) to 16 channels, three convolutional GRU cells of 16,
4 and 2 channels (3x3 kernels, h(0) = 0, each cell's h(t) the next cell's
input x(t)),

  R = sigmoid(W_r * [x, h] + b_r),  U = sigmoid(W_u * [x, h] + b_u)
  H~ = tanh(W_c * [x, R . h] + b_c),  h(t) = (1 - U) . h(t-1) + U . H~

and a 3x3 conv of the last cell's 2 channels to the logit map L(t).
Inference is winner-take-all: the depth of the first plane with the largest
logit, and the softmax probability there, 1 / sum_t exp(L(t) - max L).

Module and parameter names are the port's (``feature``, ``cost_conv``,
``gru.<i>.gates``, ``gru.<i>.candidate``, ``prob``), so one state dict loads
into this module and into the port's ``RMVSNet`` with ``strict=True``; a
cell's ``gates`` conv holds R's outputs first, then U's.

Departures from the paper, each also the port's: images and features are
channels-last at the module's boundary; the sweep is computed a chunk of
planes at a time (each plane's cost map is the same; the memory is one
chunk's); the variational depth refinement that follows the network in the
paper is left out (the benchmark serves the network's maps). Where the public
TensorFlow code (``mvsnet/model.py::inference_winner_take_all``,
``mvsnet/convgru.py``) is read to differ from the paper, this follows the
paper: that code feeds the negated 32-channel cost map to the first cell
with no 32 -> 16 conv, writes the update as U . h(t-1) + (1 - U) . H~ (U's
role reversed) and initialises the gates' bias to ones. The paper gives no
bias or activation for the 32 -> 16 conv: it has a bias (TensorFlow's
default for a conv layer) and no activation, as ``prob``.

``rounding`` (``precision.py``) rounds every conv's input and weight, each
plane's cost map and each logit map: the control. ``fault`` puts one of
``FAULTS`` in, for the readings that a correctness limit must catch:
``no_recurrence`` (every cell's state reset to 0 before every plane),
``reversed_planes`` (the recurrence run from the farthest plane to the
nearest) and ``bf16_state`` (the cells' states rounded to bfloat16 after
every step).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .mvsnet import FeatureNet, Rounding, _r, variance_volume

GRU_CHANNELS = (16, 4, 2)
FAULTS = ("no_recurrence", "reversed_planes", "bf16_state")
SWEEP_CHUNK = 16  # planes swept at once: bounds the reference's memory, not its answer


def _conv(m: nn.Conv2d, x: torch.Tensor, rounding: Rounding) -> torch.Tensor:
    return F.conv2d(_r(x, rounding), _r(m.weight, rounding), m.bias, 1, 1)


class ConvGRUCell(nn.Module):
    def __init__(self, in_channels: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.gates = nn.Conv2d(in_channels + hidden, 2 * hidden, 3, 1, 1, bias=True)
        self.candidate = nn.Conv2d(in_channels + hidden, hidden, 3, 1, 1, bias=True)

    def forward(self, x: torch.Tensor, h: torch.Tensor, rounding: Rounding = None) -> torch.Tensor:
        ru = torch.sigmoid(_conv(self.gates, torch.cat([x, h], 1), rounding))
        r, u = ru[:, : self.hidden], ru[:, self.hidden:]
        c = torch.tanh(_conv(self.candidate, torch.cat([x, r * h], 1), rounding))
        return (1 - u) * h + u * c


def winner_take_all(logits: torch.Tensor, depth_values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [B, D, h, w], depth_values [B, D] -> (depth, probability)
    [B, h, w]: the first plane of the largest logit, its depth and its
    softmax probability."""
    prob = torch.softmax(logits, dim=1)
    index = torch.argmax(logits, dim=1, keepdim=True)
    depth = torch.gather(depth_values[:, :, None, None].expand_as(logits), 1, index)[:, 0]
    return depth, torch.gather(prob, 1, index)[:, 0]


class RMVSNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.feature = FeatureNet()
        self.cost_conv = nn.Conv2d(32, GRU_CHANNELS[0], 3, 1, 1, bias=True)
        ins = (GRU_CHANNELS[0], *GRU_CHANNELS[:-1])
        self.gru = nn.ModuleList(ConvGRUCell(i, c) for i, c in zip(ins, GRU_CHANNELS))
        self.prob = nn.Conv2d(GRU_CHANNELS[-1], 1, 3, 1, 1, bias=True)

    def logits(self, feats: torch.Tensor, proj: torch.Tensor, depth_values: torch.Tensor,
               rounding: Rounding = None, fault: str | None = None) -> torch.Tensor:
        """feats [B, V, 32, h, w], proj [B, V, 4, 4], depth_values [B, D] ->
        the logit maps [B, D, h, w]."""
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
        B, V, _, h, w = feats.shape
        D = depth_values.shape[1]
        order = range(D - 1, -1, -1) if fault == "reversed_planes" else range(D)
        states = [feats.new_zeros(B, c, h, w) for c in GRU_CHANNELS]
        out = feats.new_empty(B, D, h, w)
        chunk, first = None, None
        for t in order:
            if chunk is None or not first <= t < first + SWEEP_CHUNK:
                first = t - t % SWEEP_CHUNK
                chunk = variance_volume(feats, proj, depth_values[:, first:first + SWEEP_CHUNK])
            if fault == "no_recurrence":
                states = [torch.zeros_like(s) for s in states]
            x = _conv(self.cost_conv, _r(chunk[:, :, t - first], rounding), rounding)
            for i, cell in enumerate(self.gru):
                states[i] = cell(x, states[i], rounding)
                if fault == "bf16_state":
                    states[i] = states[i].to(torch.bfloat16).float()
                x = states[i]
            out[:, t] = _r(_conv(self.prob, x, rounding)[:, 0], rounding)
        return out

    def forward(self, imgs: torch.Tensor, proj: torch.Tensor, depth_values: torch.Tensor,
                rounding: Rounding = None, fault: str | None = None) -> dict:
        """imgs [B, V, H, W, 3] in [0, 1], proj [B, V, 4, 4] (feature
        resolution), depth_values [B, D] -> {'depth', 'photometric_confidence'}
        [B, H/4, W/4] and the logit maps {'logits'} [B, D, H/4, W/4]."""
        B, V, H, W, _ = imgs.shape
        feats = self.feature(imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2), rounding)
        logits = self.logits(feats.reshape(B, V, *feats.shape[1:]), proj, depth_values, rounding, fault)
        depth, prob = winner_take_all(logits, depth_values)
        return {"depth": depth, "photometric_confidence": prob, "logits": logits}
