"""The stride-2 3x3x3 transposed conv by output parity
(``models/blocks.py::conv_transpose3d_k3s2``) against ``F.conv_transpose3d``
on the CPU: at CostRegNet's three decoder widths in f64 and f32, with odd
sizes and each output padding; in bf16 each value rounded once; the two
autograd Functions that use it (the decoder's forward, the strided convs'
input gradient) under gradcheck; and the sweep split's slice with its upper
halo against the unsplit output's planes."""

import pytest
import torch
import torch.nn.functional as F

from scene_3dreconstruction_mvsnet_tpu_torch.models.blocks import (
    _ConvK3S2,
    _ConvTransposeK3S2,
    conv_transpose3d_k3s2,
)

torch.set_num_threads(1)

DECODER = [(64, 32), (32, 16), (16, 8)]  # conv7, conv9, conv11
PADDINGS = [(1, 1, 1), (0, 0, 0), (0, 1, 0), (1, 0, 1)]


def _inputs(b, cin, cout, size, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, cin, *size, generator=g, dtype=torch.float64)
    w = torch.randn(cin, cout, 3, 3, 3, generator=g, dtype=torch.float64) / (27 * cin) ** 0.5
    return x.to(dtype), w.to(dtype)


@pytest.mark.parametrize("op", PADDINGS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("channels", DECODER, ids=str)
def test_parity_matches_conv_transpose3d(channels, b, dtype, op):
    """f64 within 1e-12 and f32 within 1e-5 of the largest |y|, on a 3x4x5
    input (odd D and W), output padding 0 or 1 on each axis."""
    x, w = _inputs(b, *channels, (3, 4, 5), dtype)
    want = F.conv_transpose3d(x, w, None, 2, 1, op)
    got = conv_transpose3d_k3s2(x, w, op)
    assert got.shape == want.shape and got.dtype == dtype
    scale = want.abs().max().item()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert (got - want).abs().max().item() <= tol * scale


@pytest.mark.parametrize("channels", DECODER, ids=str)
def test_parity_bf16_rounds_each_value_once(channels):
    """Each class is one conv over all its taps, so each bf16 value is the
    f32 sum rounded once: within one bf16 ulp of the f32 result, the ulp
    taken at the value or, where the sum cancels, at the f32 sum's own
    round-off (2^-8 of the sum of |terms|)."""
    x, w = _inputs(2, *channels, (3, 4, 5), torch.bfloat16, seed=1)
    got = conv_transpose3d_k3s2(x, w).double()
    want = F.conv_transpose3d(x.float(), w.float(), None, 2, 1, 1)
    terms = F.conv_transpose3d(x.double().abs(), w.double().abs(), None, 2, 1, 1)
    mag = torch.maximum(want.double().abs(), terms * 2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert ((got - want.to(torch.bfloat16).double()).abs() <= ulp).all()


@pytest.mark.parametrize("size", [(2, 3, 4), (3, 2, 3)], ids=str)
@pytest.mark.parametrize("fn", ["transpose", "transpose_halo", "strided"])
def test_functions_pass_gradcheck(fn, size):
    """Both Functions' input and weight gradients in f64, against numerical
    differences (odd and even sizes)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, *size, generator=g, dtype=torch.float64, requires_grad=True)
    if fn == "strided":
        w = torch.randn(2, 3, 3, 3, 3, generator=g, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(_ConvK3S2.apply, (x, w))
    else:
        w = torch.randn(3, 2, 3, 3, 3, generator=g, dtype=torch.float64, requires_grad=True)
        halo = fn == "transpose_halo"
        assert torch.autograd.gradcheck(lambda a, k: _ConvTransposeK3S2.apply(a, k, halo), (x, w))


@pytest.mark.parametrize("fn", ["transpose", "strided"])
def test_functions_match_autograd(fn):
    """The Functions' outputs and gradients equal autograd's of
    ``F.conv_transpose3d`` / ``F.conv3d`` at the decoder's widths in f64."""
    x, w = _inputs(2, 16, 8, (4, 3, 5), torch.float64, seed=3)
    if fn == "strided":
        x, w = _inputs(2, 8, 16, (6, 5, 4), torch.float64, seed=3)
        w = w.transpose(0, 1).contiguous()
        ours, plain = _ConvK3S2.apply, lambda a, k: F.conv3d(a, k, None, 2, 1)
    else:
        ours, plain = (lambda a, k: _ConvTransposeK3S2.apply(a, k, False),
                       lambda a, k: F.conv_transpose3d(a, k, None, 2, 1, 1))
    outs, grads = [], []
    for f in (ours, plain):
        a, k = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = f(a, k)
        y.backward(torch.cos(torch.arange(y.numel(), dtype=torch.float64)).reshape(y.shape))
        outs.append(y.detach())
        grads.append((a.grad, k.grad))
    assert torch.allclose(outs[0], outs[1], rtol=0, atol=1e-12)
    for ga, gb in zip(grads[0], grads[1]):
        assert torch.allclose(ga, gb, rtol=0, atol=1e-12 * gb.abs().max().item())


@pytest.mark.parametrize("ranks,rank", [(2, 0), (2, 1), (4, 1), (4, 3)])
def test_split_slice_with_halo_matches_unsplit_planes(ranks, rank):
    """One rank's slice of D with the upper neighbour's first plane (zeros
    past the volume's end), ``halo_d``: the unsplit output's 2 D_slice planes
    of that slice."""
    x, w = _inputs(1, 16, 8, (8, 3, 5), torch.float64, seed=4)
    d = x.shape[2] // ranks
    want = F.conv_transpose3d(x, w, None, 2, 1, 1)[:, :, 2 * rank * d:2 * (rank + 1) * d]
    upper = x[:, :, (rank + 1) * d:(rank + 1) * d + 1] if rank + 1 < ranks else torch.zeros_like(x[:, :, :1])
    got = conv_transpose3d_k3s2(torch.cat([x[:, :, rank * d:(rank + 1) * d], upper], 2), w, halo_d=True)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()

