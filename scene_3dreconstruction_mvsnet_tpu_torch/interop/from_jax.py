"""Load the JAX package's variables into the port's modules.

The conversion is the shared, numpy-only ``export_torch_state_dict``
(``scene_3dreconstruction_mvsnet_tpu/interop/torch_import.py``), which emits
the reference's state-dict keys with the ``module.`` prefix and flips the
ConvTranspose kernels back to torch's layout. The port's module names equal
those keys, so the result loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from scene_3dreconstruction_mvsnet_tpu.interop import export_torch_state_dict


def jax_variables_to_state_dict(variables: Mapping[str, Any], model: nn.Module) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of the JAX MVSNet (numpy leaves) -> a
    state dict for ``model``. ``export_torch_state_dict`` emits no
    ``num_batches_tracked``; each of the model's is filled with 0, the value
    of a BatchNorm that has not trained here."""
    state = {
        k.removeprefix("module."): torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        for k, v in export_torch_state_dict(variables).items()
    }
    for name, buf in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros_like(buf, device="cpu")
    return state


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy the JAX variables into ``model`` with ``strict=True``; returns
    ``model``."""
    model.load_state_dict(jax_variables_to_state_dict(variables, model), strict=True)
    return model
