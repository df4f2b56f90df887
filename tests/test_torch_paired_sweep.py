"""The port's training sweep on the CPU, against the JAX package: the plain
warp gradient (the plain version of the warp-backward kernel K3), the plain
emit-warps sweep (the plain version of K1's emit mode) and the paired
``torch.autograd.Function`` whose backward composes them.

On the CPU the kernel wrappers take their plain versions, so these tests
pin the backward formula; the kernels themselves are held against the same
plain versions on the card (tests/test_torch_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu import ops as jops
from scene_3dreconstruction_mvsnet_tpu_torch import ops as tops
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import sweep_variance as k1
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import warp_grad as k3
from scene_3dreconstruction_mvsnet_tpu_torch.ops.paired_sweep import paired_cost_volume
from tests.test_warp_grad import _rig

torch.set_num_threads(1)

H, W, C, D, V = 16, 40, 32, 4, 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("rot_deg", [0.0, 2.0])
def test_warp_src_feature_grad_matches_jax_vjp(rot_deg):
    """f32, at the bound the JAX package holds its TPU kernel to against
    autodiff (1e-4 x max|ref|)."""
    fea, projs, dv = _rig(H, W, C, D, V=2, rot_deg=rot_deg, seed=1)
    g = np.random.RandomState(2).rand(1, D, H, W, C).astype(np.float32)
    geo = (projs[1][None], projs[0][None], dv[None])

    _, vjp = jax.vjp(lambda x: jops.warp_src_feature(x, *map(jnp.asarray, geo)), jnp.asarray(fea[1][None]))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    before = k3.LAUNCHES
    got = k3.warp_grad(_t(g), *map(_t, geo))
    assert k3.LAUNCHES == before  # a CPU tensor takes the plain version
    torch.testing.assert_close(got, tops.warp_src_feature_grad(_t(g), *map(_t, geo)), rtol=0, atol=0)
    assert got.shape == (1, H, W, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())
    with pytest.raises(ValueError, match="CUDA"):
        k3.warp_grad_cuda(_t(g[0]), _t(projs[1]), _t(projs[0]), _t(dv))


@pytest.mark.parametrize("depth_chunk", [None, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emitted_warps_match_jax_warp(dtype, depth_chunk):
    """The plain sweep's emit mode: the variance is the one it returns
    without emit, and each emitted view is the JAX warp of that view (on the
    dtype-rounded features), at 1e-4 x max|ref| plus the output dtype's own
    rounding in bf16."""
    fea, projs, dv = _rig(H, W, C, D, V=V, rot_deg=2.0)
    feats = _t(fea[None]).to(dtype)
    var, warps = k1.sweep_variance(feats, _t(projs[None]), _t(dv[None]), depth_chunk=depth_chunk, emit_warps=True)
    torch.testing.assert_close(var, tops.cost_volume_variance(feats, _t(projs[None]), _t(dv[None])), rtol=0, atol=0)
    assert warps.shape == (1, V - 1, D, H, W, C) and warps.dtype == dtype
    f32 = feats.float().numpy()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -8  # + half a bf16 ulp of the largest value
    for v in range(1, V):
        ref = np.asarray(jops.warp_src_feature(
            jnp.asarray(f32[:, v]), jnp.asarray(projs[v][None]), jnp.asarray(projs[0][None]), jnp.asarray(dv[None])
        ))
        np.testing.assert_allclose(warps[:, v - 1].float().numpy(), ref, atol=(tol + 1e-4) * np.abs(ref).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_paired_grad_matches_jax_grad(dtype, tol):
    """PairedCostVolume's feature gradient (plain versions inside) against
    jax.grad of the JAX XLA sweep of the same dtype-rounded features, loss
    sum(vol^2); the tolerances of tests/test_paired_sweep.py (bf16) and
    tests/test_warp_grad.py (f32)."""
    fea, projs, dv = _rig(H, W, C, D, V=V, rot_deg=1.0, seed=3)
    rounded = _t(fea).to(dtype).float().numpy()

    def jloss(f):
        vol = jops.cost_volume_variance(f[None], jnp.asarray(projs)[None], jnp.asarray(dv)[None])
        return jnp.sum(vol * vol)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(rounded)))
    x = _t(fea[None]).to(dtype).requires_grad_(True)
    vol = paired_cost_volume(x, _t(projs[None]), _t(dv[None]))
    assert vol.dtype == dtype
    (vol.float() ** 2).sum().backward()
    assert x.grad.dtype == dtype and x.grad.shape == (1, V, H, W, C)
    np.testing.assert_allclose(x.grad[0].float().numpy(), want, atol=tol * np.abs(want).max())


def test_paired_gives_no_geometry_gradient():
    """The sweep coordinates are constants: projections and depth values
    get no gradient even when they ask for one."""
    fea, projs, dv = _rig(H, W, C, D, V=V, rot_deg=2.0)
    x = _t(fea[None]).requires_grad_(True)
    proj = _t(projs[None]).requires_grad_(True)
    depth = _t(dv[None]).requires_grad_(True)
    paired_cost_volume(x, proj, depth).sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0
    assert proj.grad is None and depth.grad is None
