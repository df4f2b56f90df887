"""Load the JAX package's variables into the port's modules.

``export_torch_state_dict`` converts the JAX MVSNet's variables (numpy
leaves) to the reference's state dict: the reference's keys with the
``module.`` prefix, each kernel moved to torch's layout and the
ConvTranspose kernels flipped back. It is the port's own copy of
``scene_3dreconstruction_mvsnet_tpu/interop/torch_import.py``'s, numpy only,
so the port loads nothing of the JAX package (tests/test_torch_interop.py
holds the two equal byte for byte). The port's module names equal those
keys, so the result loads with ``strict=True``. ``export_block_state_dict``
does the same for the two blocks MVSNet does not use, ``BasicBlock`` and
``Hourglass3d``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

_FEATURE_BN_BLOCKS = [f"conv{i}" for i in range(7)]
_COSTREG_CONV_BLOCKS = [f"conv{i}" for i in range(7)]
_COSTREG_DECONV_BLOCKS = ["conv7", "conv9", "conv11"]
_REFINE_BLOCKS = ["conv1", "conv2", "conv3", "res"]
# block -> (its ConvBnReLU children, their conv dims, its ConvTranspose children)
_BLOCKS = {
    "BasicBlock": (["conv1", "conv2", "downsample"], 2, []),
    "Hourglass3d": (["conv1a", "conv1b", "conv2a", "conv2b", "redir1", "redir2"], 3, ["dconv2", "dconv1"]),
}


def _put_bn(out: dict, prefix: str, p, s) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])
    out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
    out[f"{prefix}.running_var"] = np.asarray(s["var"])


def _put_conv_bn(out: dict, prefix: str, p, s, ndim: int) -> None:
    k = np.asarray(p["conv"]["kernel"])
    out[f"{prefix}.conv.weight"] = (
        np.transpose(k, (3, 2, 0, 1)) if ndim == 2 else np.transpose(k, (4, 3, 0, 1, 2))
    )
    _put_bn(out, f"{prefix}.bn", p["bn"], s["bn"])


def _put_deconv_bn(out: dict, prefix: str, p, s) -> None:
    """A ConvTransposeBnReLU3D: the correlation kernel flipped back to
    torch's [I, O, kd, kh, kw] under ``.0``, the BatchNorm under ``.1``."""
    k = np.asarray(p["kernel"])
    out[f"{prefix}.0.weight"] = np.transpose(k[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)).copy()
    _put_bn(out, f"{prefix}.1", p["bn"], s["bn"])


def export_torch_state_dict(variables: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Flax variables ``{"params", "batch_stats"}`` -> the reference's
    torch-layout state dict with the ``module.`` prefix (conv2d kernels
    [kh, kw, I, O] -> [O, I, kh, kw], conv3d [kd, kh, kw, I, O] ->
    [O, I, kd, kh, kw], the ConvTranspose correlation kernels flipped back to
    [I, O, kd, kh, kw])."""
    params = variables["params"]
    stats = variables["batch_stats"]
    out: dict[str, np.ndarray] = {}

    for blk in _FEATURE_BN_BLOCKS:
        _put_conv_bn(out, f"module.feature.{blk}", params["feature"][blk], stats["feature"][blk], 2)
    fk = np.asarray(params["feature"]["feature"]["kernel"])
    out["module.feature.feature.weight"] = np.transpose(fk, (3, 2, 0, 1))
    out["module.feature.feature.bias"] = np.asarray(params["feature"]["feature"]["bias"])

    creg, creg_stats = params["cost_regularization"], stats["cost_regularization"]
    for blk in _COSTREG_CONV_BLOCKS:
        _put_conv_bn(out, f"module.cost_regularization.{blk}", creg[blk], creg_stats[blk], 3)
    for blk in _COSTREG_DECONV_BLOCKS:
        _put_deconv_bn(out, f"module.cost_regularization.{blk}", creg[blk], creg_stats[blk])
    pk = np.asarray(creg["prob"]["kernel"])
    out["module.cost_regularization.prob.weight"] = np.transpose(pk, (4, 3, 0, 1, 2))
    out["module.cost_regularization.prob.bias"] = np.asarray(creg["prob"]["bias"])

    if "refine_network" in params:
        for blk in _REFINE_BLOCKS:
            _put_conv_bn(out, f"module.refine_network.{blk}", params["refine_network"][blk],
                         stats["refine_network"][blk], 2)
    return out


def export_block_state_dict(kind: str, variables: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Flax variables of the JAX package's ``BasicBlock`` or ``Hourglass3d``
    -> the reference block's state dict in torch layout (no prefix, no
    ``num_batches_tracked``), which the port's block of that name loads.
    A BasicBlock without a downsample has no ``downsample`` keys."""
    if kind not in _BLOCKS:
        raise KeyError(f"unknown block {kind!r}; available: {sorted(_BLOCKS)}")
    conv_bn, ndim, deconv_bn = _BLOCKS[kind]
    params, stats = variables["params"], variables["batch_stats"]
    out: dict[str, np.ndarray] = {}
    for blk in conv_bn:
        if blk in params:
            _put_conv_bn(out, blk, params[blk], stats[blk], ndim)
    for blk in deconv_bn:
        _put_deconv_bn(out, blk, params[blk], stats[blk])
    return out


def jax_variables_to_state_dict(variables: Mapping[str, Any], model: nn.Module) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of the JAX MVSNet (numpy leaves) -> a
    state dict for ``model``. ``export_torch_state_dict`` emits no
    ``num_batches_tracked``; each of the model's is filled with 0, the value
    of a BatchNorm that has not trained here."""
    state = {
        k.removeprefix("module."): torch.from_numpy(np.array(v, dtype=np.float32))  # a writable copy
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
