"""The port's own ``export_torch_state_dict`` against the JAX package's, on
randomly initialised JAX MVSNet variables with and without the refinement
network: the same keys, shapes, dtypes and bytes (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scene_3dreconstruction_mvsnet_tpu import models as jmodels
from scene_3dreconstruction_mvsnet_tpu.interop import export_torch_state_dict as jax_export
from scene_3dreconstruction_mvsnet_tpu_torch.interop import export_torch_state_dict


@pytest.mark.parametrize("refine", [False, True])
def test_export_torch_state_dict_equals_jax_package(refine):
    rng = np.random.RandomState(5)
    imgs = rng.rand(1, 3, 32, 32, 3).astype(np.float32)
    projs = np.broadcast_to(np.eye(4, dtype=np.float32), (1, 3, 4, 4)).copy()
    projs[:, 1, 0, 3], projs[:, 2, 0, 3] = -1.0, 1.0
    dv = np.linspace(40.0, 60.0, 8, dtype=np.float32)[None]
    variables = jmodels.MVSNet(refine=refine).init(
        jax.random.PRNGKey(int(refine)), jnp.asarray(imgs), jnp.asarray(projs), jnp.asarray(dv))
    variables = jax.tree.map(np.asarray, {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    assert ("refine_network" in variables["params"]) == refine

    want = jax_export(variables)
    got = export_torch_state_dict(variables)
    assert list(got) == list(want)
    assert any(k.startswith("module.refine_network.") for k in got) == refine
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert np.ascontiguousarray(g).tobytes() == np.ascontiguousarray(w).tobytes(), k
