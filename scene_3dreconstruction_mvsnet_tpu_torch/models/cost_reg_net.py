"""CostRegNet: the 3D U-Net cost-volume regulariser.

Counterpart of the non-flat branch of
``scene_3dreconstruction_mvsnet_tpu/models/cost_reg_net.py``: encoder 32 ->
8 -> (s2) 16 -> 16 -> (s2) 32 -> 32 -> (s2) 64 -> 64, three
ConvTranspose3d+BN+ReLU decoder stages with additive skips, and a biased
3x3x3 conv to one channel. Input [B, D, H, W, 32] -> [B, D, H, W, 1],
channels-last like the JAX module, and channels-last inside: the volume is
permuted to [B, C, D, H, W] with no copy, which is an NDHWC tensor
(``torch.channels_last_3d``), and every activation from there to ``prob``'s
output keeps that layout (``models/blocks.py``), so cuDNN's NHWC engines and
the BatchNorm and ``prob`` kernels read the volume in place and the
volume's gradient comes back as [B, D, H, W, C] with C innermost. The
decoder's transposed convs, and the stride-2 convs' input gradients, are
computed by output parity (``models/blocks.py::conv_transpose3d_k3s2``).

``fused_conv0`` is the counterpart of the JAX module's ``pallas_conv0``
(``FusedFlatConv0``): a bf16 eval forward runs conv0 + BatchNorm + ReLU
through the fused kernel K4, which reads the channels-last volume as the
sweep writes it, and writes conv0's activation NDHWC; training, and f32,
keep the module conv0. The parameters are the same either way.

With a ``sweep`` descriptor (``parallel.VolumeSharding``) the input is this
rank's slice of the depth planes and every block pads D with its
neighbours' planes (``models/blocks.py``); the output is the unsplit
network's planes of the slice. K4 then runs on the slice extended by one
neighbouring plane on each side and its two edge planes are dropped: K4 pads
D with zeros itself, so only its interior planes are the unsplit conv's (at
batch 1 the interior planes are still one NDHWC block; above it they are
copied by ``to_ndhwc``).

``in_channels`` (32: MVSNet's) and ``prob_bias`` (True: MVSNet's) make the
cascade's regularisers (``models/cas_mvsnet.py``: 32, 16 and 8 input
channels, ``prob`` without bias), each with the same layers and keys; K4
takes 32 channels only.

``prob``, the 8 -> 1 conv, runs as the hand-written kernels of
``ops/kernels/prob_conv.py`` on a CUDA tensor (forward and backward, split
or not) and as ``F.conv3d`` on a CPU tensor; its parameters are the module's.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.kernels.conv0_fused import conv0_bn_relu, fold_bn
from ..ops.kernels.prob_conv import prob_conv
from ..parallel.halo import exchange_halos
from .blocks import ConvBnReLU3D, ConvTransposeBnReLU3D, to_ndhwc


class CostRegNet(nn.Module):
    def __init__(self, fused_conv0: bool = False, in_channels: int = 32, prob_bias: bool = True):
        super().__init__()
        if fused_conv0 and in_channels != 32:
            raise ValueError(f"the fused conv0 (K4) takes 32 input channels, not {in_channels}")
        self.fused_conv0 = fused_conv0
        self.conv0 = ConvBnReLU3D(in_channels, 8)
        self.conv1 = ConvBnReLU3D(8, 16, stride=2)
        self.conv2 = ConvBnReLU3D(16, 16)
        self.conv3 = ConvBnReLU3D(16, 32, stride=2)
        self.conv4 = ConvBnReLU3D(32, 32)
        self.conv5 = ConvBnReLU3D(32, 64, stride=2)
        self.conv6 = ConvBnReLU3D(64, 64)
        self.conv7 = ConvTransposeBnReLU3D(64, 32)
        self.conv9 = ConvTransposeBnReLU3D(32, 16)
        self.conv11 = ConvTransposeBnReLU3D(16, 8)
        self.prob = nn.Conv3d(8, 1, 3, stride=1, padding=1, bias=prob_bias)

    def forward(self, x: torch.Tensor, sweep=None) -> torch.Tensor:
        """x [B, D, H, W, in_channels] in the compute dtype -> [B, D, H, W, 1]; with
        ``sweep``, D is this rank's slice."""
        if self.fused_conv0 and not self.training and x.dtype == torch.bfloat16:
            scale, bias = fold_bn(self.conv0.bn)
            if sweep is None:
                conv0 = conv0_bn_relu(x, self.conv0.conv.weight, scale, bias)
            else:
                conv0 = to_ndhwc(conv0_bn_relu(exchange_halos(x, 1, 1, 1, sweep.group), self.conv0.conv.weight,
                                               scale, bias)[:, :, 1:-1])
        else:
            conv0 = self.conv0(x.permute(0, 4, 1, 2, 3), sweep)
        conv2 = self.conv2(self.conv1(conv0, sweep), sweep)
        conv4 = self.conv4(self.conv3(conv2, sweep), sweep)
        x = self.conv6(self.conv5(conv4, sweep), sweep)
        x = conv4 + self.conv7(x, sweep)
        x = conv2 + self.conv9(x, sweep)
        x = conv0 + self.conv11(x, sweep)
        return prob_conv(x, self.prob.weight, self.prob.bias, sweep).permute(0, 2, 3, 4, 1)
