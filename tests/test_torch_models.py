"""The port's FeatureNet, CostRegNet and MVSNet forward against the JAX
package's, in f32, with the JAX variables carried over by
``load_jax_variables``; and the inference step."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from scene_3dreconstruction_mvsnet_tpu import models as jmodels
from scene_3dreconstruction_mvsnet_tpu.interop import export_torch_state_dict, import_torch_state_dict
from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
from scene_3dreconstruction_mvsnet_tpu_torch.interop import jax_variables_to_state_dict, load_jax_variables
from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet
from tests.test_models_parity import _rand_state_dict, _scene

torch.set_num_threads(1)


@pytest.fixture
def variables(rng):
    """JAX MVSNet variables (numpy leaves) from a random reference state dict."""
    return import_torch_state_dict(_rand_state_dict(rng))


@pytest.fixture
def port(variables):
    return load_jax_variables(MVSNet(), variables).eval()


def _sub(variables, name):
    return {"params": variables["params"][name], "batch_stats": variables["batch_stats"][name]}


def test_feature_net_matches_jax(rng, variables, port):
    x = rng.rand(3, 32, 40, 3).astype(np.float32)
    ref = np.asarray(jmodels.FeatureNet().apply(_sub(variables, "feature"), jnp.asarray(x), train=False))
    with torch.inference_mode():
        ours = port.feature(torch.from_numpy(x)).numpy()
    assert ours.shape == (3, 8, 10, 32)
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())


def test_cost_reg_net_matches_jax(rng, variables, port):
    x = rng.rand(1, 8, 8, 16, 32).astype(np.float32)
    ref = np.asarray(jmodels.CostRegNet().apply(_sub(variables, "cost_regularization"), jnp.asarray(x), train=False))
    with torch.inference_mode():
        ours = port.cost_regularization(torch.from_numpy(x)).numpy()
    assert ours.shape == (1, 8, 8, 16, 1)
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("depth_chunk", [None, 4])
def test_mvsnet_forward_matches_jax(rng, variables, depth_chunk):
    """The whole forward on the scene of tests/test_models_parity.py, at the
    tolerances the JAX package holds its model to against torch."""
    imgs, projs, dv = _scene(rng)
    ref = jmodels.MVSNet(refine=False).apply(
        variables, jnp.asarray(imgs), jnp.asarray(projs), jnp.asarray(dv), train=False
    )
    port = load_jax_variables(MVSNet(depth_chunk=depth_chunk), variables).eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(imgs), torch.from_numpy(projs), torch.from_numpy(dv))
    assert set(out) == {"depth", "photometric_confidence"}
    depth_err = np.abs(out["depth"].numpy() - np.asarray(ref["depth"]))
    assert depth_err.max() < 1e-3 * (dv.max() - dv.min()), depth_err.max()
    np.testing.assert_allclose(out["photometric_confidence"].numpy(),
                               np.asarray(ref["photometric_confidence"]), atol=1e-4)


def test_infer_step_u8_matches_jax(rng, variables, port):
    """u8 images are divided by 255 on the device, as the JAX infer step does."""
    imgs, projs, dv = _scene(rng)
    u8 = (imgs * 255).astype(np.uint8)
    ref = jmodels.MVSNet().apply(variables, jnp.asarray(u8.astype(np.float32) / 255.0),
                                 jnp.asarray(projs), jnp.asarray(dv), train=False)
    out = make_infer_step(port, "cpu")(torch.from_numpy(u8), torch.from_numpy(projs), torch.from_numpy(dv))
    assert not port.training
    assert np.abs(out["depth"].numpy() - np.asarray(ref["depth"])).max() < 1e-3 * (dv.max() - dv.min())
    np.testing.assert_allclose(out["photometric_confidence"].numpy(),
                               np.asarray(ref["photometric_confidence"]), atol=1e-4)


def test_load_jax_variables_round_trips_strict(variables, port):
    """Every key of the JAX export lands in the port unchanged, the
    BatchNorm counters are filled, and a missing key is refused."""
    exported = {k.removeprefix("module."): v for k, v in export_torch_state_dict(variables).items()}
    state = port.state_dict()
    assert set(state) == set(exported) | {k for k in state if k.endswith("num_batches_tracked")}
    # BN layers: FeatureNet conv0-6, CostRegNet conv0-6 and its three decoder stages
    assert sum(k.endswith("num_batches_tracked") for k in state) == 7 + 7 + 3
    for k, v in exported.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
    # the port's modules carry the reference's names
    assert "feature.conv0.conv.weight" in state and "cost_regularization.conv7.0.weight" in state
    partial = jax_variables_to_state_dict(variables, port)
    del partial["cost_regularization.prob.bias"]
    with pytest.raises(RuntimeError, match="prob.bias"):
        MVSNet().load_state_dict(partial, strict=True)
