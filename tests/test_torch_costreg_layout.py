"""CostRegNet's NDHWC layout on the card (marker ``cuda``).

Every 3D block's output is NDHWC (``torch.channels_last_3d``) and the
fallback copy ``models/blocks.py::to_ndhwc`` never runs, in a bf16 eval
forward of MVSNet's CostRegNet (with and without K4) and the cascade's three
and in a bf16 training step; the volume's gradient reaches K3-terms with
its channels innermost (stride 1), so K3-terms takes its 16-byte path; K4's
NDHWC output matches the module conv0. The file imports nothing of JAX, so
the card's machine runs it with
``python -m pytest tests/test_torch_costreg_layout.py -m cuda --noconftest``."""

import contextlib

import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu_torch.models import random_init_
from scene_3dreconstruction_mvsnet_tpu_torch.models.blocks import ConvBnReLU3D, ConvTransposeBnReLU3D
from scene_3dreconstruction_mvsnet_tpu_torch.models.cost_reg_net import CostRegNet
from scene_3dreconstruction_mvsnet_tpu_torch.ops import paired_sweep
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import bf16_ulps
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import conv0_fused as k4
from scene_3dreconstruction_mvsnet_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda
NDHWC = torch.channels_last_3d


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@contextlib.contextmanager
def _layouts(net):
    """Record every 3D block's output layout, and the spans, while open."""
    seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out: seen.append(out.is_contiguous(memory_format=NDHWC)))
             for m in net.modules() if isinstance(m, (ConvBnReLU3D, ConvTransposeBnReLU3D))]
    tracing.enable()
    try:
        yield seen
    finally:
        tracing.disable()
        for h in hooks:
            h.remove()


@pytest.mark.parametrize("in_channels,prob_bias,fused", [(32, True, False), (32, True, True), (32, False, False),
                                                         (16, False, False), (8, False, False)])
def test_cost_reg_net_runs_ndhwc_on_the_card(cuda, in_channels, prob_bias, fused):
    """A bf16 eval forward and a training step: every block's output NDHWC,
    no ``costreg.to_ndhwc`` span (K4's conv0 is no block: 9 outputs)."""
    gen = torch.Generator(device=cuda).manual_seed(in_channels)
    net = random_init_(CostRegNet(fused_conv0=fused, in_channels=in_channels, prob_bias=prob_bias).to(cuda), gen)
    x = torch.randn((1, 16, 24, 40, in_channels), generator=gen, device=cuda).to(torch.bfloat16)
    with _layouts(net) as seen:
        with torch.no_grad():
            net.eval()(x)
        assert len(seen) == (9 if fused else 10) and all(seen)
        seen.clear()
        vol = x.clone().requires_grad_()
        net.train()(vol).float().square().mean().backward()
        spans = [s["name"] for s in tracing.take()["spans"]]
    assert len(seen) == 10 and all(seen)
    assert "costreg.to_ndhwc" not in spans
    assert vol.grad.is_contiguous()  # [B, D, H, W, C]: the permuted view's gradient, channels innermost


def _rig(B: int, V: int, H: int, W: int, D: int, device):
    """Projection matrices at feature resolution (a reference camera at the
    origin, sources shifted along x) and D depth planes in front of it."""
    K = torch.eye(4)
    K[:3, :3] = torch.tensor([[float(W), 0.0, W / 2], [0.0, float(W), H / 2], [0.0, 0.0, 1.0]])
    proj = torch.empty((B, V, 4, 4))
    for v in range(V):
        E = torch.eye(4)
        E[0, 3] = 0.05 * v
        proj[:, v] = K @ E
    return proj.to(device), torch.linspace(2.0, 3.0, D).expand(B, D).contiguous().to(device)


def test_the_volume_gradient_reaches_k3_terms_channels_innermost(cuda, monkeypatch):
    """The paired sweep (K1-emit) into a bf16 CostRegNet, one training
    backward: K3-terms gets the volume's gradient with stride(4) == 1 and
    every stride a multiple of 8 (its 16-byte loads)."""
    seen = []
    real = paired_sweep.paired_grad

    def spy(g_vol, *args, **kwargs):
        seen.append(g_vol.stride())
        return real(g_vol, *args, **kwargs)

    monkeypatch.setattr(paired_sweep, "paired_grad", spy)
    gen = torch.Generator(device=cuda).manual_seed(3)
    feats = torch.randn((2, 3, 24, 72, 32), generator=gen, device=cuda).to(torch.bfloat16).requires_grad_()
    proj, depth = _rig(2, 3, 24, 72, 16, cuda)
    net = random_init_(CostRegNet().to(cuda), gen).train()
    net(paired_sweep.paired_cost_volume(feats, proj, depth)).float().square().mean().backward()
    assert seen and all(s[4] == 1 and all(x % 8 == 0 for x in s[:4]) for s in seen), seen


def test_conv0_fused_kernel_matches_the_module_conv0(cuda):
    """K4's output, NDHWC, against CostRegNet's module conv0 on the same
    bf16-rounded volume and weights in f32 (cuDNN's conv, TF32 off, then the
    BatchNorm kernel in eval, NDHWC too): within one bf16 ulp, the ulp taken
    at no less than 1e-3 x the largest (K4's test)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    net = random_init_(CostRegNet().to(cuda), gen).eval()
    with torch.no_grad():
        net.conv0.conv.weight.copy_(net.conv0.conv.weight.to(torch.bfloat16).float())
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(1, 13, 24, 40, 32).astype(np.float32)).to(cuda, torch.bfloat16)
    with torch.no_grad():
        out = k4.conv0_bn_relu(x, net.conv0.conv.weight, *k4.fold_bn(net.conv0.bn))
        want = net.conv0(x.float().permute(0, 4, 1, 2, 3))
    assert out.is_contiguous(memory_format=NDHWC) and want.is_contiguous(memory_format=NDHWC)
    assert bool((want == 0).any()) and bool((want > 0).any())
    assert bf16_ulps(out, want, floor=1e-3 * want.abs().max().item()) <= 1.0
