"""Conv/BN building blocks of MVSNet (2D and 3D), and R-MVSNet's
convolutional GRU cell (``ConvGRUCell``). The 2D blocks take NCHW tensors;
the 3D blocks take [B, C, D, H, W] tensors laid out NDHWC in memory
(``torch.channels_last_3d``) and return them so.

Counterpart of the non-flat blocks of
``scene_3dreconstruction_mvsnet_tpu/models/blocks.py``. Module names follow
the reference's state-dict keys (``conv``/``bn``; ``0``/``1`` for the
transposed-conv stages), so the JAX package's exported weights load with
``strict=True``. BatchNorm has flax's training semantics: eps 1e-5,
running-stat momentum 0.1 (flax's 0.9), and the running variance updated
with the biased batch variance, as flax does (torch's own BatchNorm uses
the unbiased one).

Parameters stay f32. Every conv computes in the dtype of its input (bf16 on
the fast path, f32 otherwise) with its weights cast to it, as the JAX blocks
cast params to the computation dtype; BatchNorm takes the low-precision input
with its f32 parameters. A 3D block's BatchNorm and the ReLU after it run as
the hand-written kernels of ``ops/kernels/batch_norm.py`` on a CUDA tensor.

NDHWC: cuDNN's bf16 3D engines are NHWC, so a 3D conv's input and weight go
to it channels-last and its output comes back so, and the BatchNorm kernels
read and write that layout; nothing is transposed between the sweep's
volume and ``prob``. A 3D conv's weight is cast channels-last with its dtype.
PyTorch's CPU conv3d writes NCDHW in f32 and f64, so on the CPU a 3D conv's
output is copied to NDHWC (``_conv3d``). An input in another layout (an
NCDHW tensor a caller hands a 3D block) is copied once by ``to_ndhwc``,
inside the ``costreg.to_ndhwc`` span, which counts how often that happens.

In training, a BatchNorm whose ``process_group`` holds more than one rank
(set by ``parallel.make_sharded_train_step``) takes its statistics over the
global batch, as the JAX package's sharded step does under GSPMD; while
``recomputing`` (a rematerialised segment's backward) it updates no buffer,
as flax discards the recompute's ``batch_stats``.

The 3D blocks take an optional ``sweep`` (``parallel.VolumeSharding``):
the input is then this rank's slice of the depth axis, and D is padded with
the neighbouring ranks' planes (``parallel/halo.py``) instead of zeros, so
the block computes the unsplit block's planes of this slice. In training,
their BatchNorm reduces over the ranks whose slices make the statistics
(``parallel.make_sharded_train_step``).
"""

from __future__ import annotations

import functools
import itertools

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.batch_norm import batch_norm_relu, batch_norm_relu_plain
from ..parallel.collectives import all_reduce_sum, world_size
from ..parallel.halo import exchange_halos
from ..utils import tracing


class _FlaxRunningVar:
    """BatchNorm whose training step updates the running variance with the
    biased batch variance, as flax's BatchNorm does
    (``scene_3dreconstruction_mvsnet_tpu/models/blocks.py:118-124``), with
    the ReLU that follows it when called with ``relu=True``.

    ``normalize`` computes it: torch's kernels with the running variance
    rescaled (``ops/kernels/batch_norm.py::batch_norm_relu_plain``) for
    BatchNorm2d; for BatchNorm3d the hand-written kernels on a CUDA tensor,
    which give the biased variance directly, and the same plain version on
    a CPU tensor. Normalisation and the running-stat update run in f32 for
    bf16 input."""

    process_group = None  # the ranks whose batches make the global batch
    recomputing = False  # set while a checkpointed segment is recomputed
    normalize = staticmethod(batch_norm_relu_plain)

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        if self.training and world_size(self.process_group) > 1:
            y = self._global_batch_norm(x)
            return F.relu(y) if relu else y
        return self.normalize(self, x, relu)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Batch statistics over every rank's batch: the per-channel sum, then
        the sum of squared deviations from the global mean, each reduced
        over the ranks in f32 (f64 for f64 input) and differentiable; the
        running variance takes the biased global variance, as flax's."""
        group = self.process_group
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        xa = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
        n = x.numel() // x.shape[1] * world_size(group)
        mean = all_reduce_sum(xa.sum(dims), group) / n
        centred = xa - mean.reshape(shape)
        var = all_reduce_sum(centred.square().sum(dims), group) / n
        y = centred * (self.weight * torch.rsqrt(var + self.eps)).reshape(shape) + self.bias.reshape(shape)
        if not self.recomputing:
            self.num_batches_tracked.add_(1)
            with torch.no_grad():
                self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
                self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
        return y.to(x.dtype)


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxRunningVar, nn.BatchNorm3d):
    """On NDHWC input (another layout goes through ``to_ndhwc``); the
    kernels on a CUDA tensor."""

    normalize = staticmethod(batch_norm_relu)

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return super().forward(to_ndhwc(x), relu)


def _cast(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    """A parameter in the compute dtype; a 3D conv's weight also NDHWC."""
    if p is None:
        return None
    return p.to(dtype, memory_format=torch.channels_last_3d) if p.dim() == 5 else p.to(dtype)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """``x`` [B, C, D, H, W] laid out NDHWC: ``x`` itself when it already is,
    else a copy made inside the ``costreg.to_ndhwc`` span (``utils/
    tracing.py``), so a traced run counts every fallback."""
    if x.is_contiguous(memory_format=torch.channels_last_3d):
        return x
    with tracing.span("costreg.to_ndhwc"):
        return x.contiguous(memory_format=torch.channels_last_3d)


def _conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, stride, padding) -> torch.Tensor:
    """``F.conv3d`` of NDHWC x and w -> NDHWC. cuDNN writes that layout from
    them; PyTorch's CPU conv3d writes NCDHW in f32 and f64, copied here."""
    y = F.conv3d(x, w, b, stride, padding)
    return y if y.is_cuda else y.contiguous(memory_format=torch.channels_last_3d)


@functools.lru_cache(maxsize=None)
def _parity_taps(device: torch.device) -> torch.Tensor:
    """64 indices into a 3x3x3 kernel's 27 taps and a zero 28th: for
    output-parity class (pd, ph, pw) and its 2x2x2 window tap (td, th, tw),
    the tap that class reads there. Per axis, y[2m] = w[1] x[m] and y[2m+1] =
    w[2] x[m] + w[0] x[m+1]: class 0 takes tap 0 -> w[1] (tap 1 is zero),
    class 1 tap 0 -> w[2] and tap 1 -> w[0]."""
    axis = ((1, None), (2, 0))  # [class][window tap] -> kernel tap, or none
    index = []
    for cls in itertools.product((0, 1), repeat=3):
        for tap in itertools.product((0, 1), repeat=3):
            k = [axis[c][t] for c, t in zip(cls, tap)]
            index.append(27 if None in k else k[0] * 9 + k[1] * 3 + k[2])
    return torch.tensor(index, device=device)


def _parity_weight(w: torch.Tensor) -> torch.Tensor:
    """The stride-2 3x3x3 transposed conv's weight ``w`` [Cin, Cout, 3, 3, 3]
    -> the output-parity classes' correlation kernels as one conv's weight,
    [8 Cout, Cin, 2, 2, 2] NDHWC: output channel (pd, ph, pw, o), then the
    taps (``_parity_taps``); three launches: the zero tap, the gather, the
    layout."""
    cin, cout = w.shape[:2]
    taps = F.pad(w.reshape(cin, cout, 27), (0, 1)).index_select(2, _parity_taps(w.device))  # [Cin, Cout, class tap]
    taps = taps.view(cin, cout, 8, 8).permute(2, 1, 3, 0).contiguous()  # [class, Cout, tap, Cin]: NDHWC
    return taps.view(8 * cout, 2, 2, 2, cin).permute(0, 4, 1, 2, 3)


def conv_transpose3d_k3s2(x: torch.Tensor, w: torch.Tensor, output_padding=(1, 1, 1),
                          halo_d: bool = False) -> torch.Tensor:
    """``F.conv_transpose3d(x, w, None, 2, 1, output_padding)`` by output
    parity, x NDHWC and ``w`` [Cin, Cout, 3, 3, 3] in the dtype of ``x`` ->
    NDHWC. The 8 classes (pd, ph, pw) are one stride-1 conv on a 2x2x2
    window over ``x`` padded by one zero plane at the upper end of each axis,
    8 Cout channels out (``_parity_weight``; a class's missing taps are
    zero), so each output value is rounded once; one depth-to-space copy
    interleaves them, from [b, m_d, m_h, m_w, (pd, ph, pw, o)] to
    [b, 2 m_d + pd, 2 m_h + ph, 2 m_w + pw, o], the Cout channels of a voxel
    contiguous on both sides. (Eight convs, each a class with only its own
    taps, took 2.4-3.8x as long on an H100 at CostRegNet's shapes.)
    ``output_padding`` 0 on an axis drops its last (odd) plane, which costs
    a second copy. With ``halo_d``, the last plane of D is the upper
    neighbour's (``parallel/halo.py``) and stands in for the zero plane:
    D_slice + 1 planes give the slice's 2 D_slice. The ``deconv.parity``
    span (``utils/tracing.py``)."""
    with tracing.span("deconv.parity"):
        xp = F.pad(x, (0, 1, 0, 1, 0, 0 if halo_d else 1))
        b, cout, n = x.shape[0], w.shape[1], [s - 1 for s in xp.shape[2:]]
        y = _conv3d(xp, _parity_weight(w), None, 1, 0).permute(0, 2, 3, 4, 1).reshape(b, *n, 2, 2, 2, cout)
        y = y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, *(2 * s for s in n), cout).permute(0, 4, 1, 2, 3)
        keep = [2 * s - 1 + p for s, p in zip(n, (1 if halo_d else output_padding[0], *output_padding[1:]))]
        if keep == list(y.shape[2:]):
            return y
        return y[..., :keep[0], :keep[1], :keep[2]].contiguous(memory_format=torch.channels_last_3d)


class _ConvTransposeK3S2(torch.autograd.Function):
    """The decoder's ConvTranspose3d(k3, s2, p1, output_padding 1): the
    forward by output parity (``conv_transpose3d_k3s2``), the backward as
    autograd runs it for ``F.conv_transpose3d`` (the input's gradient a
    strided cuDNN conv, the weight's cuDNN's wgrad). With ``halo_d`` the op
    is the transposed conv of the D_slice + 1 planes with no output padding
    on D, its last plane dropped."""

    @staticmethod
    def forward(ctx, x, w, halo_d):
        ctx.save_for_backward(x, w)
        ctx.halo_d = halo_d
        return conv_transpose3d_k3s2(x, w, halo_d=halo_d)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if ctx.halo_d:
            g = F.pad(g, (0, 0, 0, 0, 0, 1))
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, (2, 2, 2), (1, 1, 1), (1, 1, 1), True, (0 if ctx.halo_d else 1, 1, 1), 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None


class _ConvK3S2(torch.autograd.Function):
    """Conv3d(k3, s2, p1): the forward cuDNN's, the input's gradient by
    output parity (it is ``conv_transpose3d(g, w, stride 2, padding 1)``,
    with output padding 1 on an even axis of the input and 0 on an odd one),
    the weight's cuDNN's wgrad, as autograd runs it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv3d(x, w, None, 2, 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = conv_transpose3d_k3s2(g, w, tuple(1 - s % 2 for s in x.shape[2:]))
        if ctx.needs_input_grad[1]:
            gw = torch.ops.aten.convolution_backward(
                g, x, w, None, (2, 2, 2), (1, 1, 1), (1, 1, 1), False, (0, 0, 0), 1, [False, True, False])[1]
        return gx, gw


def _is_k3s2(module: nn.Module) -> bool:
    """A bias-free Conv3d(k3, s2, p1): its input gradient is the stride-2
    transposed conv that ``conv_transpose3d_k3s2`` computes."""
    return (isinstance(module, nn.Conv3d) and module.bias is None and module.kernel_size == (3, 3, 3)
            and module.stride == (2, 2, 2) and module.padding == (1, 1, 1))


def conv(module: nn.Conv2d | nn.Conv3d, x: torch.Tensor, sweep=None) -> torch.Tensor:
    """Apply ``module`` in the dtype of ``x``; a 3D conv takes and returns
    NDHWC (an input in another layout goes through ``to_ndhwc``). With
    ``sweep``, ``module`` a 3x3x3 conv with padding 1, to this rank's slice
    of D. The stride-1 conv y[d] reads x[d-1..d+1], so the slice takes one
    plane from each neighbour; the stride-2 conv y[d] reads x[2d-1..2d+1], so
    it takes one lower plane only (the slice starts on an even plane). D
    then takes no padding, and the stride-2 conv keeps autograd's backward.
    Unsplit, a Conv3d(k3, s2, p1) takes its input's gradient by output
    parity (``_ConvK3S2``)."""
    if isinstance(module, nn.Conv2d):
        return F.conv2d(x, _cast(module.weight, x.dtype), _cast(module.bias, x.dtype), module.stride,
                        module.padding)
    x = to_ndhwc(x)
    padding = module.padding
    if sweep is not None:
        x = exchange_halos(x, 2, 1, 1 if module.stride[0] == 1 else 0, sweep.group)
        padding = (0, *module.padding[1:])
    elif _is_k3s2(module):
        return _ConvK3S2.apply(x, _cast(module.weight, x.dtype))
    return _conv3d(x, _cast(module.weight, x.dtype), _cast(module.bias, x.dtype), module.stride, padding)


class ConvBnReLU(nn.Module):
    """2D conv (no bias) + BatchNorm + optional ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, pad: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride, pad, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(conv(self.conv, x))
        return F.relu(x) if self.relu else x


class ConvBnReLU3D(nn.Module):
    """3D conv (no bias) + BatchNorm + optional ReLU on [B, C, D, H, W]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, pad: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size, stride, pad, bias=False)
        self.bn = BatchNorm3d(out_channels, eps=1e-5, momentum=0.1)
        self.relu = relu

    def forward(self, x: torch.Tensor, sweep=None) -> torch.Tensor:
        return self.bn(conv(self.conv, x, sweep), relu=self.relu)


class ConvTransposeBnReLU3D(nn.Sequential):
    """ConvTranspose3d(k=3, s=2, p=1, output_padding=1, no bias) + BatchNorm
    + optional ReLU, the decoder stage of CostRegNet (and, without the ReLU,
    of Hourglass3d); output spatial dims are exactly twice the input's.
    Children ``0`` and ``1`` carry the reference's keys."""

    def __init__(self, in_channels: int, out_channels: int, relu: bool = True):
        super().__init__(
            nn.ConvTranspose3d(in_channels, out_channels, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            BatchNorm3d(out_channels, eps=1e-5, momentum=0.1),
        )
        self.relu = relu

    def forward(self, x: torch.Tensor, sweep=None) -> torch.Tensor:
        """The transposed conv by output parity (``_ConvTransposeK3S2``), on
        NDHWC (another layout goes through ``to_ndhwc``). With ``sweep``:
        y[2i] reads x[i] and y[2i+1] reads x[i] and x[i+1], so the slice takes
        one upper plane, which stands in for the zero plane on D: the slice's
        2 D_slice planes."""
        deconv, bn = self[0], self[1]
        x = to_ndhwc(x)
        if sweep is not None:
            x = exchange_halos(x, 2, 0, 1, sweep.group)
        x = _ConvTransposeK3S2.apply(x, _cast(deconv.weight, x.dtype), sweep is not None)
        return bn(x, relu=self.relu)


class BasicBlock(nn.Module):
    """Stride-``stride`` residual block: ConvBnReLU, then conv + BN, plus the
    input (through a 1x1 conv + BN when ``downsample``). The reference
    defines it and MVSNet does not use it; children ``conv1``, ``conv2``
    and ``downsample`` carry the reference's keys."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, downsample: bool = False):
        super().__init__()
        self.conv1 = ConvBnReLU(in_channels, out_channels, 3, stride, 1)
        self.conv2 = ConvBnReLU(out_channels, out_channels, 3, 1, 1, relu=False)
        self.downsample = ConvBnReLU(in_channels, out_channels, 1, stride, 0, relu=False) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return out + (x if self.downsample is None else self.downsample(x))


class ConvGRUCell(nn.Module):
    """Convolutional GRU cell of R-MVSNet (Yao et al. 2019, §3.3) on
    [B, C, H, W] maps, 3x3 kernels with padding 1:

      R = sigmoid(W_r * [x, h] + b_r),  U = sigmoid(W_u * [x, h] + b_u)
      H~ = tanh(W_c * [x, R . h] + b_c)
      h' = (1 - U) . h + U . H~

    ``gates`` is one conv with 2 ``hidden`` outputs (R the first ``hidden``
    channels, U the rest), ``candidate`` one conv with ``hidden`` outputs.
    The convs compute in the dtype of ``x`` (the state cast to it as their
    input, weights cast per conv); the gates' arithmetic and the returned
    state are in the dtype of ``h`` (f32 on every path, f64 in a test)."""

    def __init__(self, in_channels: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.gates = nn.Conv2d(in_channels + hidden, 2 * hidden, 3, 1, 1, bias=True)
        self.candidate = nn.Conv2d(in_channels + hidden, hidden, 3, 1, 1, bias=True)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        ru = torch.sigmoid(conv(self.gates, torch.cat([x, h.to(x.dtype)], 1)).to(h.dtype))
        r, u = ru[:, : self.hidden], ru[:, self.hidden :]
        c = torch.tanh(conv(self.candidate, torch.cat([x, (r * h).to(x.dtype)], 1)).to(h.dtype))
        return (1 - u) * h + u * c


class Hourglass3d(nn.Module):
    """Two-level 3D hourglass on [B, C, D, H, W] with 1x1x1 redirect convs:
    down twice with stride-2 convs, up twice with transposed convs, each
    level's input added back before its ReLU. The reference defines it and
    MVSNet does not use it; children carry the reference's keys (``dconv*``
    are ConvTranspose3d + BatchNorm3d under ``0``/``1``)."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.conv1a = ConvBnReLU3D(c, 2 * c, 3, 2, 1)
        self.conv1b = ConvBnReLU3D(2 * c, 2 * c, 3, 1, 1)
        self.conv2a = ConvBnReLU3D(2 * c, 4 * c, 3, 2, 1)
        self.conv2b = ConvBnReLU3D(4 * c, 4 * c, 3, 1, 1)
        self.dconv2 = ConvTransposeBnReLU3D(4 * c, 2 * c, relu=False)
        self.dconv1 = ConvTransposeBnReLU3D(2 * c, c, relu=False)
        self.redir1 = ConvBnReLU3D(c, c, 1, 1, 0, relu=False)
        self.redir2 = ConvBnReLU3D(2 * c, 2 * c, 1, 1, 0, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1 = self.conv1b(self.conv1a(x))
        conv2 = self.conv2b(self.conv2a(conv1))
        dconv2 = F.relu(self.dconv2(conv2) + self.redir2(conv1))
        return F.relu(self.dconv1(dconv2) + self.redir1(x))
