"""The port's plain sampling and plane-sweep variance against the JAX
package's XLA path, on the same numpy inputs.

JAX's own tests hold its Pallas sweep kernel against that same XLA
function; the port's CUDA kernel is held against the port's plain path on
the card (tests/test_torch_kernels.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scene_3dreconstruction_mvsnet_tpu import ops as jops
from scene_3dreconstruction_mvsnet_tpu_torch import ops as tops
from scene_3dreconstruction_mvsnet_tpu_torch.geometry.transforms import relative_projection
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import sweep_variance as k1
from tests.test_sweep_variance import _rig

torch.set_num_threads(1)

H, W, C, D, V = 16, 40, 32, 4, 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_bilinear_and_grid_sample_match_jax(rng):
    img = rng.randn(2, 9, 13, 4).astype(np.float32)
    # coordinates beyond the image on every side exercise the zero padding
    x = (rng.rand(2, 50) * 19 - 3).astype(np.float32)
    y = (rng.rand(2, 50) * 15 - 3).astype(np.float32)
    ours = tops.bilinear_sample_2d(_t(img), _t(x), _t(y)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jops.bilinear_sample_2d(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))),
                               atol=1e-5)
    grid = (rng.rand(2, 5, 7, 2).astype(np.float32) * 3.0) - 1.5
    ours = tops.grid_sample_2d(_t(img), _t(grid)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jops.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid))), atol=1e-5)


@pytest.mark.parametrize("rot_deg", [0.0, 2.0])
def test_warp_src_feature_matches_jax(rot_deg):
    fea, projs, dv = _rig(H, W, C, D, V, rot_deg=rot_deg)
    args = (fea[2][None], projs[2][None], projs[0][None], dv[None])
    ref = np.asarray(jops.warp_src_feature(*map(jnp.asarray, args)))
    ours = tops.warp_src_feature(*map(_t, args)).numpy()
    assert ours.shape == (1, D, H, W, C)
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("depth_chunk", [None, 2])
@pytest.mark.parametrize("rot_deg", [0.0, 2.0])
def test_cost_volume_variance_matches_jax(rot_deg, depth_chunk):
    fea, projs, dv = _rig(H, W, C, D, V, rot_deg=rot_deg)
    ref = np.asarray(jops.cost_volume_variance(jnp.asarray(fea[None]), jnp.asarray(projs[None]), jnp.asarray(dv[None])))
    ours = tops.cost_volume_variance(_t(fea[None]), _t(projs[None]), _t(dv[None]), depth_chunk=depth_chunk).numpy()
    assert ours.shape == (1, D, H, W, C) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())


def test_cost_volume_variance_bf16_features_match_jax():
    """bf16 features sampled in f32 with f32 sums: held to the tolerance the
    JAX package holds its bf16 TPU kernel to."""
    fea, projs, dv = _rig(H, W, C, D, V, rot_deg=2.0)
    fea_bf = torch.from_numpy(fea).to(torch.bfloat16)
    ref = np.asarray(jops.cost_volume_variance(jnp.asarray(fea_bf.float().numpy()[None]),
                                               jnp.asarray(projs[None]), jnp.asarray(dv[None])))
    ours = tops.cost_volume_variance(fea_bf[None], _t(projs[None]), _t(dv[None]), out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-3 * np.abs(ref).max())
    # default out_dtype is the features' dtype
    assert tops.cost_volume_variance(fea_bf[None], _t(projs[None]), _t(dv[None])).dtype == torch.bfloat16


def test_sweep_wrapper_takes_plain_path_on_cpu():
    fea, projs, dv = _rig(H, W, C, D, V, rot_deg=2.0)
    before = k1.LAUNCHES
    out = k1.sweep_variance(_t(fea[None]), _t(projs[None]), _t(dv[None]), depth_chunk=2)
    plain = tops.cost_volume_variance(_t(fea[None]), _t(projs[None]), _t(dv[None]))
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    assert k1.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        k1.sweep_variance_cuda(_t(fea), _t(projs), _t(dv))


def test_homography_terms_are_the_plain_paths():
    """The 9+3 floats the kernel takes per source view are, bit for bit, the
    relative projection the plain sweep computes for a one-sample batch:
    ``relative_projection(proj[:, v], proj[:, 0])`` on [1, 4, 4] slices, as
    ``cost_volume_variance`` hands them to ``plane_sweep_coords``."""
    _, projs, _ = _rig(H, W, C, D, V, rot_deg=2.0)
    terms = k1.homography_terms(_t(projs))
    assert terms.shape == (V - 1, 12) and terms.dtype == torch.float32
    proj = _t(projs[None])  # [B=1, V, 4, 4], the plain path's layout
    for v in range(1, V):
        rot, trans = relative_projection(proj[:, v], proj[:, 0])
        torch.testing.assert_close(terms[v - 1], torch.cat([rot.reshape(9), trans.reshape(3)]), rtol=0, atol=0)
