"""The roofline's counts: the convolutions' FLOPs against
``torch.utils.flop_counter.FlopCounterMode`` over the reference forward,
and each layer's bound against a count by hand."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mvsbench import roofline
from mvsbench.reference import mvsnet as ref_mvsnet


@pytest.mark.parametrize("B,V,D,H,W", [(1, 3, 8, 32, 64), (2, 4, 16, 64, 96)])
def test_conv_flops_match_the_flop_counter(B, V, D, H, W):
    model = ref_mvsnet.MVSNet().eval()
    imgs = torch.rand(B, V, H, W, 3)
    proj = torch.eye(4).expand(B, V, 4, 4).clone()
    proj[:, :, 0, 3] = torch.arange(V, dtype=torch.float32)
    planes = torch.linspace(400.0, 900.0, D).expand(B, D).contiguous()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(imgs, proj, planes)
    counts = counter.get_flop_counts()["Global"]
    convs = sum(n for op, n in counts.items() if "convolution" in str(op))
    want = 2 * (roofline.feature_macs(B * V, H, W) + roofline.costreg_macs(B, D, H // 4, W // 4))
    assert convs == want
    assert roofline.forward_flops(B, V, D, H, W) == want + roofline.sweep_flops(B, V, D, H // 4, W // 4) \
        + roofline.regression_flops(B, D, H // 4, W // 4)
    assert roofline.train_step_flops(B, V, D, H, W) == 3 * roofline.forward_flops(B, V, D, H, W)


def test_the_bounds_by_hand():
    B, V, D, h, w, C = 1, 5, 192, 144, 200, 32
    points = D * h * w
    # sweep, bf16 in and out: 5 feature maps read, one volume written; 4 source views of
    # (8 coordinate flops + 32 x (8 tap + 3 moment) flops) and 32 x 5 for the variance per point
    assert roofline.sweep_bytes(B, V, D, h, w, C, "bf16", "bf16") == 5 * h * w * 32 * 2 + points * 32 * 2
    flops = points * (4 * (8 + 32 * 11) + 32 * 5)
    assert roofline.sweep_flops(B, V, D, h, w, C) == flops
    assert roofline.sweep_bound_s(B, V, D, h, w, C, "bf16", "bf16") == pytest.approx(
        max(flops / 67e12, (5 * h * w * 64 + points * 64) / 3.35e12))
    # regression, bf16 logits: the logits and the planes read, depth and confidence written
    assert roofline.regression_bytes(B, D, h, w, "bf16") == points * 2 + D * 4 + 2 * h * w * 4
    assert roofline.regression_bound_s(B, D, h, w, "bf16") == pytest.approx((points * 2 + D * 4 + 8 * h * w) / 3.35e12)
    # the sweep's backward at the training recipe: the volume's bf16 gradient and the bf16 features read,
    # the features' f32 gradient written
    B, V, D, h, w = 4, 3, 192, 128, 160
    nbytes = B * D * h * w * 32 * 2 + B * V * h * w * 32 * (2 + 4)
    assert roofline.sweep_backward_bytes(B, V, D, h, w, 32, "bf16", "bf16") == nbytes
    flops = B * D * h * w * (2 * (8 + 32 * 19) + 32 * (3 + 5))
    assert roofline.sweep_backward_flops(B, V, D, h, w, 32) == flops
    assert roofline.sweep_backward_bound_s(B, V, D, h, w, 32, "bf16", "bf16") == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12))


def test_the_costreg_count_by_hand():
    # conv0 32->8 and prob 8->1 at full resolution, then the encoder and the transposed decoder
    B, D, h, w = 1, 8, 8, 8
    full, half, quarter, eighth = 512, 64, 8, 1
    want = 27 * (full * (32 * 8 + 8 * 1) + half * (8 * 16 + 16 * 16) + quarter * (16 * 32 + 32 * 32)
                 + eighth * (32 * 64 + 64 * 64) + eighth * 64 * 32 + quarter * 32 * 16 + half * 16 * 8)
    assert roofline.costreg_macs(B, D, h, w) == want
