"""The port's softmax regression and photometric confidence against the JAX
package's plain path and its Pallas kernel (interpret mode)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scene_3dreconstruction_mvsnet_tpu.ops import regress_depth_and_confidence as j_regress
from scene_3dreconstruction_mvsnet_tpu.ops.pallas.softmax_regression import fused_softmax_regression
from scene_3dreconstruction_mvsnet_tpu_torch.ops import regress_depth_and_confidence
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import softmax_regression as k2

torch.set_num_threads(1)


def _inputs(rng, B, D, H, W, scale):
    cost = (rng.randn(B, D, H, W) * scale).astype(np.float32)
    dv = np.linspace(425, 905, D, dtype=np.float32)[None].repeat(B, 0)
    return cost, dv


@pytest.mark.parametrize("reference", ["plain", "pallas_interpret"])
@pytest.mark.parametrize("shape,scale", [((2, 24, 16, 20), 3.0), ((1, 16, 13, 9), 0.5)])
def test_regression_matches_jax(rng, reference, shape, scale):
    cost, dv = _inputs(rng, *shape, scale)
    if reference == "plain":
        ref_depth, ref_conf = j_regress(jnp.asarray(cost), jnp.asarray(dv))
    else:
        ref_depth, ref_conf = fused_softmax_regression(jnp.asarray(cost), jnp.asarray(dv), interpret=True)
    depth, conf = regress_depth_and_confidence(torch.from_numpy(cost), torch.from_numpy(dv))
    assert depth.shape == conf.shape == (shape[0], shape[2], shape[3])
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref_depth), atol=1e-4 * (dv.max() - dv.min()))
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref_conf), atol=1e-5)


def test_confidence_window_at_truncated_index():
    """A two-plane distribution with E[index] = 2.75: the window is planes
    [1, 4] around the truncated index 2, so it holds all of the mass; at
    E[index] = 0.5 the window [-1, 2] is clipped at the front."""
    D = 8
    p = torch.zeros(1, D, 1, 2)
    p[0, 2, 0, 0], p[0, 5, 0, 0] = 0.75, 0.25  # E = 2.75 -> idx 2 -> planes 1..4 hold 0.75
    p[0, 0, 0, 1], p[0, 1, 0, 1] = 0.5, 0.5  # E = 0.5 -> idx 0 -> planes 0..2 hold 1.0
    depth, conf = regress_depth_and_confidence(torch.log(p), torch.arange(D, dtype=torch.float32)[None])
    torch.testing.assert_close(depth[0, 0], torch.tensor([2.75, 0.5]))
    torch.testing.assert_close(conf[0, 0], torch.tensor([0.75, 1.0]))


def test_regression_wrapper_takes_plain_path_on_cpu(rng):
    cost, dv = _inputs(rng, 1, 12, 5, 6, 2.0)
    before = k2.LAUNCHES
    depth, conf = k2.softmax_regression(torch.from_numpy(cost), torch.from_numpy(dv))
    ref_depth, ref_conf = regress_depth_and_confidence(torch.from_numpy(cost), torch.from_numpy(dv))
    torch.testing.assert_close(depth, ref_depth, rtol=0, atol=0)
    torch.testing.assert_close(conf, ref_conf, rtol=0, atol=0)
    assert k2.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        k2.softmax_regression_cuda(torch.from_numpy(cost), torch.from_numpy(dv))
