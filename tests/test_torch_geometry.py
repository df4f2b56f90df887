"""The port's geometry (scene_3dreconstruction_mvsnet_tpu_torch.geometry)
against the JAX package's, on the same numpy inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scene_3dreconstruction_mvsnet_tpu import geometry as jgeo
from scene_3dreconstruction_mvsnet_tpu_torch import geometry as tgeo
from tests.test_sampling import _random_projection
from tests.test_sweep_variance import _rig

torch.set_num_threads(1)


def test_compose_and_invert_match_jax(rng):
    K = rng.rand(2, 3, 3).astype(np.float32) * 50 + np.eye(3, dtype=np.float32) * 100
    E = _random_projection(rng, 2)  # any well-conditioned 4x4 stands in for E
    ours = tgeo.compose_projection_matrix(torch.from_numpy(K), torch.from_numpy(E)).numpy()
    ref = np.asarray(jgeo.compose_projection_matrix(jnp.asarray(K), jnp.asarray(E)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-4)
    inv = tgeo.invert_4x4(torch.from_numpy(ours)).numpy()
    np.testing.assert_allclose(inv, np.asarray(jgeo.invert_4x4(jnp.asarray(ref))), rtol=1e-4, atol=1e-6)


def test_pixel_grid_matches_jax():
    np.testing.assert_array_equal(tgeo.pixel_grid(5, 7).numpy(), np.asarray(jgeo.pixel_grid(5, 7)))


@pytest.mark.parametrize("rig", ["random", "rotated"])
def test_plane_sweep_coords_match_jax(rng, rig):
    """Source-view pixel coordinates within 1e-3 px."""
    if rig == "random":
        H, W = 12, 20
        projs = np.stack([_random_projection(rng, 2) for _ in range(2)])  # [2 views, B=2, 4, 4]
        src, ref = projs[1], projs[0]
        dv = np.stack([np.linspace(40, 60, 6), np.linspace(30, 70, 6)]).astype(np.float32)
    else:
        H, W = 16, 40
        _, p, d = _rig(H, W, 1, 6, 3, rot_deg=2.0)
        src, ref, dv = p[2:3], p[0:1], d[None]
    jx, jy = jgeo.plane_sweep_coords(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(dv), H, W)
    tx, ty = tgeo.plane_sweep_coords(torch.from_numpy(src), torch.from_numpy(ref), torch.from_numpy(dv), H, W)
    assert tx.shape == (src.shape[0], dv.shape[1], H * W)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-3)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-3)
