"""The port's Hopper kernels against their plain PyTorch versions. They need
an NVIDIA GPU (and nvcc / triton): marked ``cuda``, they skip elsewhere.
The machine with the card has no JAX, which tests/conftest.py imports, so
this file imports nothing of JAX and runs there with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``."""

import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu_torch.ops import cost_volume_variance, regress_depth_and_confidence
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import softmax_regression as k2
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import sweep_variance as k1

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _rig(H, W, C, D, V, rot_deg):
    """Random features and a translated rig whose views turn by ``rot_deg``
    each (the rig of tests/test_sweep_variance.py)."""
    rng = np.random.RandomState(0)
    fea = rng.rand(V, H, W, C).astype(np.float32)
    K = np.array([[0.7 * W, 0, W / 8], [0, 0.7 * W, H / 8], [0, 0, 1]], np.float32)
    projs = []
    for v in range(V):
        a = np.deg2rad(rot_deg * v)
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        E[0, 3], E[1, 3] = -2.0 * v, 0.3 * v
        P = E.copy()
        P[:3, :4] = K @ E[:3, :4]
        projs.append(P)
    return fea, np.stack(projs), np.linspace(425.0, 905.0, D, dtype=np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("in_dtype,out_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.float32, 2e-3),
    (torch.bfloat16, torch.bfloat16, 1e-2),  # + the output's own bf16 rounding
])
@pytest.mark.parametrize("rot_deg", [0.0, 2.0])
def test_sweep_variance_kernel_matches_plain(cuda, rot_deg, in_dtype, out_dtype, tol):
    fea, projs, dv = _rig(24, 72, 32, 7, 4, rot_deg=rot_deg)
    feats = torch.from_numpy(fea).to(cuda, in_dtype)[None]
    proj = torch.from_numpy(projs).to(cuda)[None]
    depth = torch.from_numpy(dv).to(cuda)[None]
    before = k1.LAUNCHES
    out = k1.sweep_variance(feats, proj, depth, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1 and out.dtype == out_dtype and out.shape == (1, 7, 24, 72, 32)
    ref = cost_volume_variance(feats, proj, depth, out_dtype=torch.float32)
    scale = ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol * scale


def test_softmax_regression_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    cost = torch.randn((2, 192, 20, 36), generator=gen, device=cuda) * 3.0
    dv = torch.linspace(425.0, 905.0, 192, device=cuda)[None].repeat(2, 1)
    before = k2.LAUNCHES
    depth, conf = k2.softmax_regression(cost, dv)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    ref_depth, ref_conf = regress_depth_and_confidence(cost, dv)
    d_diff = (depth - ref_depth).abs()
    assert d_diff.max().item() <= 1e-4 * 480.0
    # truncation of the expected index may differ where it sits on an integer
    e_idx = (ref_depth - 425.0) * (191 / 480.0)
    near_int = (e_idx - e_idx.round()).abs() < d_diff * (191 / 480.0) + 1e-4
    assert (conf - ref_conf).abs()[~near_int].max().item() <= 1e-5


def test_kernels_refuse_what_they_do_not_take(cuda):
    feats = torch.zeros((1, 2, 8, 8, 12), device=cuda)  # channels not a multiple of 8
    proj = torch.eye(4, device=cuda).repeat(1, 2, 1, 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        k1.sweep_variance(feats, proj, torch.ones((1, 3), device=cuda))
    with pytest.raises(TypeError):
        k2.softmax_regression(torch.zeros((1, 4, 2, 2), device=cuda, dtype=torch.float16),
                              torch.ones((1, 4), device=cuda))
