"""CostRegNet channels-last end to end, held against the JAX package.

Over MVSNet's CostRegNet (32 input channels, ``prob`` with a bias) and the
cascade's three (32, 16 and 8 input channels, ``prob`` without one), split
over the sweep axis by a group of one rank and unsplit, with and without
``--remat``: every 3D block's output is NDHWC (``torch.channels_last_3d``),
the fallback copy ``models/blocks.py::to_ndhwc`` never runs (no
``costreg.to_ndhwc`` span), the eval output matches the JAX module in f32 at
``test_cost_reg_net_matches_jax``'s tolerance and the training step's f64
gradients (every parameter's and the volume's) at
``test_train_step_matches_jax``'s."""

import contextlib
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from scene_3dreconstruction_mvsnet_tpu import models as jmodels
from scene_3dreconstruction_mvsnet_tpu_torch.interop.from_jax import (
    _COSTREG_CONV_BLOCKS,
    _COSTREG_DECONV_BLOCKS,
    _put_conv_bn,
    _put_deconv_bn,
)
from scene_3dreconstruction_mvsnet_tpu_torch.models.blocks import ConvBnReLU3D, ConvTransposeBnReLU3D
from scene_3dreconstruction_mvsnet_tpu_torch.models.cost_reg_net import CostRegNet
from scene_3dreconstruction_mvsnet_tpu_torch.models.mvsnet import _recomputing
from scene_3dreconstruction_mvsnet_tpu_torch.utils import tracing

torch.set_num_threads(1)
SHAPE = (1, 8, 8, 16)  # B, D, H, W of the volume
NETS = [(32, True), (32, False), (16, False), (8, False)]  # MVSNet's; the cascade's stages 1-3


def _state_dict(params, stats, prob_bias: bool) -> dict[str, torch.Tensor]:
    """The JAX CostRegNet's variables (or a gradient tree with its stats)
    -> the port's CostRegNet state dict."""
    out: dict = {}
    for blk in _COSTREG_CONV_BLOCKS:
        _put_conv_bn(out, blk, params[blk], stats[blk], 3)
    for blk in _COSTREG_DECONV_BLOCKS:
        _put_deconv_bn(out, blk, params[blk], stats[blk])
    out["prob.weight"] = np.transpose(np.asarray(params["prob"]["kernel"]), (4, 3, 0, 1, 2))
    if prob_bias:
        out["prob.bias"] = np.asarray(params["prob"]["bias"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float64)) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _reference(in_channels: int, prob_bias: bool):
    """JAX variables (BatchNorm affines drawn away from 1 and 0; the bias 0
    where the port's prob has none), a volume, its eval output (f32), and in
    f64 the training step's gradients of sum(out * r) for a drawn r."""
    rng = np.random.default_rng(in_channels + 7 * prob_bias)
    x = rng.random((*SHAPE, in_channels))
    r = rng.standard_normal((*SHAPE, 1))
    jnet = jmodels.CostRegNet()
    variables = jax.device_get(jnet.init(jax.random.PRNGKey(in_channels), jnp.asarray(x, jnp.float32)))

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale":
            return 1.0 + 0.2 * rng.standard_normal(leaf.shape)
        if name == "bias":
            return 0.2 * rng.standard_normal(leaf.shape) if prob_bias or path[0].key != "prob" else 0.0 * leaf
        return np.asarray(leaf, np.float64)

    params = jax.tree_util.tree_map_with_path(draw, variables["params"])
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables["batch_stats"])
    f32 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), t)  # noqa: E731
    out = np.asarray(jnet.apply({"params": f32(params), "batch_stats": f32(stats)}, jnp.asarray(x, jnp.float32),
                                train=False))
    with jax.enable_x64(True):
        def loss(p, v):
            y, _ = jnet.apply({"params": p, "batch_stats": stats}, v, train=True, mutable=["batch_stats"])
            return jnp.sum(y * r)

        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        gp, gx = jax.device_get(jax.grad(loss, argnums=(0, 1))(f64(params), jnp.asarray(x)))
    return _state_dict(params, stats, prob_bias), x, r, out, _state_dict(gp, stats, prob_bias), np.asarray(gx)


@contextlib.contextmanager
def _traced():
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()


@pytest.mark.parametrize("in_channels,prob_bias", NETS)
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_cost_reg_net_is_ndhwc_end_to_end_and_matches_jax(in_channels, prob_bias, split, remat):
    state, x, r, want_out, want_grads, want_gx = _reference(in_channels, prob_bias)
    net = CostRegNet(in_channels=in_channels, prob_bias=prob_bias)
    counters = {k: torch.zeros_like(b) for k, b in net.named_buffers() if k.endswith("num_batches_tracked")}
    net.load_state_dict({**{k: v.float() for k, v in state.items()}, **counters}, strict=True)
    sweep = SimpleNamespace(group=None) if split else None  # a group of one rank: zero halos
    layouts = []
    for m in net.modules():
        if isinstance(m, (ConvBnReLU3D, ConvTransposeBnReLU3D)):
            m.register_forward_hook(lambda mod, args, out: layouts.append(
                out.is_contiguous(memory_format=torch.channels_last_3d)))

    with _traced():
        with torch.no_grad():
            out = net.eval()(torch.from_numpy(x).float(), sweep)
        np.testing.assert_allclose(out.numpy(), want_out, atol=1e-4 * np.abs(want_out).max())

        net.double().train()
        vol = torch.from_numpy(x).requires_grad_()
        if remat:
            y = checkpoint(net, vol, sweep, use_reentrant=False,
                           context_fn=lambda: (contextlib.nullcontext(), _recomputing(net)))
        else:
            y = net(vol, sweep)
        (y * torch.from_numpy(r)).sum().backward()
        spans = [s["name"] for s in tracing.take()["spans"]]

    assert layouts and all(layouts), layouts
    assert len(layouts) == 10 * (3 if remat else 2)  # 7 convs + 3 decoder stages a forward, again in the recompute
    # the decoder's three transposed convs a forward (eval, training, the recompute), and unsplit the
    # stride-2 convs' three input gradients
    assert "costreg.to_ndhwc" not in spans
    assert spans.count("deconv.parity") == 3 * (3 if remat else 2) + (0 if split else 3)
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert set(grads) <= set(want_grads)
    for k, g in grads.items():
        want = want_grads[k]
        assert (g - want).abs().max() <= 1e-3 * want.abs().max(), k
    np.testing.assert_allclose(vol.grad.numpy(), want_gx, atol=1e-3 * np.abs(want_gx).max())
