"""The port's RefineNet and ``MVSNet(refine=True)`` against the JAX package's,
in f32 and bf16, with the JAX variables carried over by
``load_jax_variables``; and a refine checkpoint saved by the port, loaded by
the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu import models as jmodels
from scene_3dreconstruction_mvsnet_tpu.interop import export_torch_state_dict, import_torch_state_dict
from scene_3dreconstruction_mvsnet_tpu.interop.torch_import import load_torch_checkpoint
from scene_3dreconstruction_mvsnet_tpu_torch.interop import load_jax_variables
from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
from scene_3dreconstruction_mvsnet_tpu_torch.train import make_optimizer, save_checkpoint
from tests.test_models_parity import _rand_state_dict, _scene

torch.set_num_threads(1)

DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _refine_state_dict(rng):
    """_rand_state_dict's reference-shaped MVSNet weights plus the
    refinement head's (conv1 4 -> 32, conv2, conv3 32 -> 32, res 32 -> 1)."""
    sd = _rand_state_dict(rng)
    for blk, (cin, cout) in {"conv1": (4, 32), "conv2": (32, 32), "conv3": (32, 32), "res": (32, 1)}.items():
        p = f"module.refine_network.{blk}"
        sd[f"{p}.conv.weight"] = rng.randn(cout, cin, 3, 3).astype(np.float32) * 0.2
        sd[f"{p}.bn.weight"] = rng.rand(cout).astype(np.float32) + 0.5
        sd[f"{p}.bn.bias"] = rng.randn(cout).astype(np.float32) * 0.1 + 0.5  # a residual mostly above the ReLU
        sd[f"{p}.bn.running_mean"] = rng.randn(cout).astype(np.float32) * 0.1
        sd[f"{p}.bn.running_var"] = rng.rand(cout).astype(np.float32) + 0.5
    return sd


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_refine_net_matches_jax(rng, dtype):
    """RefineNet alone on a [2, 64, 80, 3] image and a [2, 16, 20] depth map
    at 425-935 mm (a 4x downsample, so the resize antialiases): the residual
    within 1e-4 x its largest magnitude in f32 (8e-7 measured). In bf16 both
    packages cast the concatenated input to bf16 and run four bf16 convs,
    each rounding its output to bf16 after an f32 BatchNorm; the residuals
    were equal here, and are held within one bf16 step of the largest
    (4e-3 x it), added to the same f32 depth."""
    jdtype, tdtype = DTYPES[dtype]
    variables = import_torch_state_dict(_refine_state_dict(rng), refine=True)
    img = rng.rand(2, 64, 80, 3).astype(np.float32)
    depth = (425.0 + 510.0 * rng.rand(2, 16, 20)).astype(np.float32)
    sub = {"params": variables["params"]["refine_network"], "batch_stats": variables["batch_stats"]["refine_network"]}
    ref = np.asarray(jmodels.RefineNet(dtype=jdtype).apply(sub, jnp.asarray(img), jnp.asarray(depth), train=False))
    port = load_jax_variables(MVSNet(refine=True), variables).eval()
    with torch.inference_mode():
        out = port.refine_network(torch.from_numpy(img), torch.from_numpy(depth), tdtype or torch.float32)
    assert out.dtype == torch.float32 and out.shape == (2, 16, 20)
    res, want = out.numpy() - depth, ref.astype(np.float32) - depth
    assert (want >= 0).all() and (want > 0).mean() > 0.3  # the last ReLU: a residual that is never negative
    tol = 1e-4 if dtype == "f32" else 4e-3
    np.testing.assert_allclose(res, want, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mvsnet_refine_matches_jax(rng, dtype):
    """The whole eval forward with the refinement head on the scene of
    tests/test_models_parity.py: ``depth`` and ``refined_depth`` within
    1e-3 x the depth range in f32 (the model parity bound). In bf16 the
    weights are flax's initialisation with non-trivial running statistics,
    as in tests/test_torch_conv0.py, and both maps are held within 2e-2 x
    the depth range (the JAX package's bf16 model bound,
    tests/test_conv0_fused.py)."""
    jdtype, tdtype = DTYPES[dtype]
    imgs, projs, dv = _scene(rng)
    jmodel = jmodels.MVSNet(refine=True, dtype=jdtype)
    if dtype == "f32":
        variables = import_torch_state_dict(_refine_state_dict(rng), refine=True)
    else:
        variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(projs), jnp.asarray(dv))
        variables = jax.tree.map(np.asarray, {"params": variables["params"], "batch_stats": jax.tree.map(
            lambda a: a + 0.1 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape) / a.size,
            variables["batch_stats"])})
    ref = jmodel.apply(variables, jnp.asarray(imgs), jnp.asarray(projs), jnp.asarray(dv), train=False)
    port = load_jax_variables(MVSNet(refine=True, dtype=tdtype), variables).eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(imgs), torch.from_numpy(projs), torch.from_numpy(dv))
    assert set(out) == {"depth", "photometric_confidence", "refined_depth"}
    tol = (1e-3 if dtype == "f32" else 2e-2) * (dv.max() - dv.min())
    for key in ("depth", "refined_depth"):
        err = np.abs(out[key].numpy() - np.asarray(ref[key], np.float32)).max()
        assert err < tol, (key, err)
    assert (out["refined_depth"] >= out["depth"]).all()


def test_refine_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint of MVSNet(refine=True) written by the port's
    save_checkpoint loads in the JAX package with load_torch_checkpoint(...,
    refine=True), and every weight and running statistic comes back
    unchanged through the JAX package's export."""
    model = random_init_(MVSNet(refine=True), torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), 0, model, make_optimizer(model, 1e-3))
    variables = load_torch_checkpoint(path, refine=True)
    assert set(variables["params"]["refine_network"]) == {"conv1", "conv2", "conv3", "res"}
    back = export_torch_state_dict(variables)
    state = {"module." + k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(back) == set(state) and any(k.startswith("module.refine_network.") for k in back)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
