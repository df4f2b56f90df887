"""The single-view plane-sweep warp wrapper (K5, ``ops/kernels/
plane_sweep_warp.py``; its plain version on the CPU) against the JAX
package's warp and its v1 Pallas warp kernel, on the scene and rigs of
tests/test_pallas_warp.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scene_3dreconstruction_mvsnet_tpu.ops.sampling import warp_src_feature as jax_warp
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import plane_sweep_warp as k5
from tests.test_pallas_warp import _proj

torch.set_num_threads(1)

RIGS = [(0.0, 0.0), (-2.0, 0.0), (-3.0, 2.0)]


@pytest.fixture(scope="module")
def scene():
    H, W, C, D = 32, 160, 32, 3
    rng = np.random.RandomState(0)
    fea = rng.rand(H, W, C).astype(np.float32)
    K = np.array([[0.7 * W, 0, W / 8], [0, 0.7 * W, H / 8], [0, 0, 1]], np.float32)
    return fea, K, np.linspace(425, 905, D, dtype=np.float32)


def _port_warp(fea, src, ref, dv):
    before = k5.LAUNCHES
    out = k5.plane_sweep_warp(*(torch.from_numpy(a)[None] for a in (fea, src, ref, dv)))[0].numpy()
    assert k5.LAUNCHES == before  # CPU tensors take the plain version
    return out


@pytest.mark.parametrize("tx,ty", RIGS)
def test_plane_sweep_warp_matches_jax(scene, tx, ty):
    """f32 features, the same coordinates computed in another order: within
    1e-4 x max|ref|, the sweep's f32 tolerance (tests/test_torch_sweep.py)."""
    fea, K, dv = scene
    src, ref = _proj(K, tx=tx, ty=ty), _proj(K)
    want = np.asarray(jax_warp(*(jnp.asarray(a)[None] for a in (fea, src, ref, dv))))[0]
    got = _port_warp(fea, src, ref, dv)
    assert got.shape == want.shape == (3, 32, 160, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.slow
@pytest.mark.parametrize("tx,ty", RIGS)
def test_plane_sweep_warp_matches_jax_pallas_kernel(scene, tx, ty):
    """Against the v1 Pallas kernel in interpret mode, at the 5e-4 the JAX
    package holds that kernel to against its XLA warp."""
    from scene_3dreconstruction_mvsnet_tpu.ops.pallas.plane_sweep_warp import warp_src_feature_pallas

    fea, K, dv = scene
    src, ref = _proj(K, tx=tx, ty=ty), _proj(K)
    want, valid = warp_src_feature_pallas(*(jnp.asarray(a) for a in (fea, src, ref, dv)), interpret=True)
    assert bool(valid)
    np.testing.assert_allclose(_port_warp(fea, src, ref, dv), np.asarray(want), atol=5e-4)


@pytest.mark.parametrize("D,H,W,C", [(192, 216, 288, 32), (7, 24, 72, 32), (19, 24, 72, 16), (2, 5, 13, 8)])
def test_plane_sweep_warp_launch_geometry(D, H, W, C):
    """K5's launch covers every (pixel, channel group) and every plane with
    no empty chunk, walks 16 planes per thread at the headline (whole steps
    of 4 planes), and refuses a plane that 32-bit indices cannot address."""
    g = k5.launch_geometry(D, H, W, C)
    assert g["grid"][0] * g["threads"] >= H * W * (C // 8) > (g["grid"][0] - 1) * g["threads"]
    assert g["d_chunk"] * g["grid"][1] >= D > (g["grid"][1] - 1) * g["d_chunk"]
    assert g["d_chunk"] == min(D, 16 if (H, W) == (216, 288) else 4)
    with pytest.raises(ValueError, match="2\\^31"):
        k5.launch_geometry(D, 4096, 4096, 128)
