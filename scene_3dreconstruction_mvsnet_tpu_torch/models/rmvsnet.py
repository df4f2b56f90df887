"""R-MVSNet: MVSNet's cost volume regularised by convolutional GRUs that run
plane by plane along depth, inference.

Yao et al., "Recurrent MVSNet for High-resolution Multi-view Stereo Depth
Inference" (CVPR, 2019, arXiv:1902.10556), §3.3; the public TensorFlow code
(github.com/YoYo000/MVSNet, ``mvsnet/model.py::inference_winner_take_all``
with ``--regularization GRU``, ``mvsnet/convgru.py``).

The call is MVSNet's: imgs [B, V, H, W, 3] (view 0 the reference), the K@E
projections [B, V, 4, 4] at 1/4 resolution and the depth planes [B, D].

- FeatureNet (``models/feature_net.py``, MVSNet's: 32 channels at 1/4);
- the variance cost maps C(t) [B, 32, h, w] of consecutive chunks of
  ``PLANE_CHUNK`` planes (K1, ``sweep_variance``, per-plane depths): the
  live cost volume is one chunk, whatever D is;
- for each plane t in order of increasing depth: ``cost_conv`` (3x3, 32 ->
  16) on C(t), three ``ConvGRUCell`` (16, 4 and 2 channels; h(0) = 0, each
  cell's h(t) the next cell's input) and ``prob`` (3x3, 2 -> 1): the logit
  map L(t), written into a [B, D, h, w] f32 buffer;
- winner-take-all over the buffer (``winner_take_all``): the depth of the
  first plane with the largest logit and its softmax probability,
  1 / sum_t exp(L(t) - max L), as ``photometric_confidence``.

Returns ``depth`` and ``photometric_confidence`` [B, h, w], so
``infer.py::make_infer_step`` serves it as it serves MVSNet.

Precision: the convs take their inputs and weights in ``dtype`` (bf16 on
the fast path): the cost maps, the cells' inputs and their states as conv
inputs. The hidden states, the gates' arithmetic and the logits stay f32:
``prob`` multiplies the bf16 values of its input and weights in f32, so no
logit is rounded to bf16. Depths and projections stay f32.

On a CUDA device each plane's step (the 32 -> 16 conv, the cells and the
logit conv, ~90 kernels) is replayed from a CUDA graph captured at the
first call (``_GraphStep``): launched one by one, the host issues them more
slowly than the card runs them, and a request's time follows the host's,
whose speed varies with what else its machine runs.

Spans (``utils/tracing.py``): ``rmvsnet.features`` (FeatureNet),
``rmvsnet.recurrence`` (every plane, the K1 chunks included), inside it
``rmvsnet.sweep`` (each K1 chunk), and ``rmvsnet.regress`` (the
winner-take-all pass). Each chunk is one K1 launch a sample, counted under
``sweep_variance``.

A forward in training mode with gradients on raises: R-MVSNet has no
training path yet (``missing_paths``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.sweep_variance import sweep_variance
from ..utils import tracing
from .blocks import ConvGRUCell, conv
from .feature_net import FeatureNet

# K1's planes a launch: the one chunk of the cost volume that is live. A
# sweep of 32 planes at 300x400 is 246 MB in bf16; PERF.md gives the
# measurement that chose it.
PLANE_CHUNK = 32
GRU_CHANNELS = (16, 4, 2)


def winner_take_all(logits: torch.Tensor, depth_values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [B, D, h, w] f32, depth_values [B, D] -> (depth, probability)
    [B, h, w]: the depth of the plane with the largest logit (the first of
    equal ones) and that plane's softmax probability, 1 / sum_t exp(L(t) -
    max L)."""
    top, index = logits.max(dim=1)
    prob = torch.exp(logits - top[:, None]).sum(dim=1).reciprocal()
    B = logits.shape[0]
    depth = torch.gather(depth_values, 1, index.reshape(B, -1)).reshape(index.shape)
    return depth, prob


class RMVSNet(nn.Module):
    """R-MVSNet for inference (see the module's docstring).

    Args:
      dtype: compute dtype of the convs and of the cost maps; None is f32,
        ``torch.bfloat16`` the fast path. Parameters stay f32.
    """

    # the ROADMAP.md item that plans each path this model lacks
    missing_paths = {"train": "ROADMAP.md, Queue 4 item 4: R-MVSNet training",
                     "eval": "ROADMAP.md, Queue 4 item 1: eval_cli --model rmvsnet"}

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.feature = FeatureNet()
        self.cost_conv = nn.Conv2d(32, GRU_CHANNELS[0], 3, 1, 1, bias=True)
        ins = (GRU_CHANNELS[0], *GRU_CHANNELS[:-1])
        self.gru = nn.ModuleList(ConvGRUCell(i, c) for i, c in zip(ins, GRU_CHANNELS))
        self.prob = nn.Conv2d(GRU_CHANNELS[-1], 1, 3, 1, 1, bias=True)
        self._graphs: dict = {}  # the last captured plane step on a CUDA device, by what it was captured for

    def forward(self, imgs: torch.Tensor, proj_matrices: torch.Tensor,
                depth_values: torch.Tensor) -> dict[str, torch.Tensor]:
        if self.training and torch.is_grad_enabled():
            raise NotImplementedError("R-MVSNet has no training path yet: the cross-entropy over the probability "
                                      f"volume, K1-emit in chunks and a reference step ({self.missing_paths['train']})")
        B, V, H, W, C = imgs.shape
        if proj_matrices.shape[1] != V:
            raise ValueError(f"got {V} images but {proj_matrices.shape[1]} projection matrices")
        dtype = self.dtype or torch.float32
        proj_matrices, depth_values = proj_matrices.float(), depth_values.float()
        D = depth_values.shape[1]
        with tracing.span("rmvsnet.features"):
            feats = self.feature(imgs.reshape(B * V, H, W, C).to(dtype))
        h, w = feats.shape[1:3]
        feats = feats.reshape(B, V, h, w, feats.shape[-1])
        logits = torch.empty((B, D, h, w), dtype=torch.float32, device=feats.device)
        with tracing.span("rmvsnet.recurrence"):
            step = self._plane_step(B, h, w, dtype, feats.device)
            for state in step.states:
                state.zero_()
            for start in range(0, D, PLANE_CHUNK):
                with tracing.span("rmvsnet.sweep"):
                    volume = sweep_variance(feats, proj_matrices, depth_values[:, start:start + PLANE_CHUNK],
                                            out_dtype=dtype)
                for k in range(volume.shape[1]):
                    logits[:, start + k] = step(volume[:, k])
        with tracing.span("rmvsnet.regress"):
            depth, confidence = winner_take_all(logits, depth_values)
        return {"depth": depth, "photometric_confidence": confidence}

    def step(self, cost: torch.Tensor, states: list[torch.Tensor]) -> torch.Tensor:
        """One plane: cost [B, h, w, 32] (channels-last, the compute dtype),
        the cells' states [B, c, h, w] f32, updated in place -> L(t) [B, h, w]
        f32. ``prob``'s weights are rounded to the compute dtype and it runs
        in f32 on the last state as its input rounds it."""
        dtype = cost.dtype
        x = conv(self.cost_conv, cost.permute(0, 3, 1, 2))
        for cell, state in zip(self.gru, states):
            state.copy_(cell(x, state))
            x = state.to(dtype)
        return F.conv2d(x.float(), self.prob.weight.to(dtype).float(), self.prob.bias, 1, 1)[:, 0]

    def _plane_step(self, B: int, h: int, w: int, dtype: torch.dtype, device: torch.device):
        """``step`` with its states for maps of [B, h, w]: on a CUDA device
        replayed from a CUDA graph (``_GraphStep``), captured at the first
        call for these parameters' storage, shape, dtype and inference mode
        (the last such graph is kept); on the CPU called as it is."""
        if device.type != "cuda":
            return _EagerStep(self, B, h, w, device)
        key = (B, h, w, dtype, device, torch.is_inference_mode_enabled(),
               tuple(p.data_ptr() for p in self.parameters()))
        if key not in self._graphs:
            self._graphs.clear()
            self._graphs[key] = _GraphStep(self, B, h, w, dtype, device)
        return self._graphs[key]


class _EagerStep:
    """``RMVSNet.step`` on states of its own, zeros at first."""

    def __init__(self, model: RMVSNet, B: int, h: int, w: int, device: torch.device):
        self.model = model
        self.states = [torch.zeros((B, c, h, w), dtype=torch.float32, device=device) for c in GRU_CHANNELS]

    def __call__(self, cost: torch.Tensor) -> torch.Tensor:
        return self.model.step(cost, self.states)


class _GraphStep(_EagerStep):
    """``RMVSNet.step`` captured in a CUDA graph: one replay a plane in place
    of its ~90 launches, which the host issues slower than the card runs
    them. The cost map is copied into a fixed buffer and the logit map read
    from one; the states are the graph's own, updated in place. Run twice on
    a side stream before the capture (cuDNN's handles and workspaces), as
    ``torch.cuda.graphs`` asks; a replay runs the captured kernels, so it
    gives the eager step's bits."""

    def __init__(self, model: RMVSNet, B: int, h: int, w: int, dtype: torch.dtype, device: torch.device):
        super().__init__(model, B, h, w, device)
        self.cost = torch.zeros((B, h, w, 32), dtype=dtype, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                model.step(self.cost, self.states)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logit = model.step(self.cost, self.states)

    def __call__(self, cost: torch.Tensor) -> torch.Tensor:
        self.cost.copy_(cost)
        self.graph.replay()
        return self.logit
