"""CostRegNet's ``prob`` conv kernels (``ops/kernels/prob_conv.py``), on
NDHWC volumes.

On the CPU: the wrapper's plain version is today's ``conv(self.prob, x,
sweep)`` bit for bit; mirrors of the three kernels' loops over D (chunks,
padding planes, the rolling planes, the dgrad's flipped taps) hold to
``F.conv3d`` and its autograd in f64; the launch plan covers every output
once. Marked ``cuda``: the kernels against the plain version at the cells'
shapes, bf16 and f32, with and without bias, with zero padding on D and with
the sweep split's halo planes. The file imports nothing of JAX, so the
card's machine runs it with
``python -m pytest tests/test_torch_prob_conv.py -m cuda --noconftest``."""

from types import SimpleNamespace

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from scene_3dreconstruction_mvsnet_tpu_torch.models.blocks import conv
from scene_3dreconstruction_mvsnet_tpu_torch.models.cost_reg_net import CostRegNet
from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import bf16_ulps
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import prob_conv as kp

torch.set_num_threads(1)
U32 = 2.0 ** -24  # f32's unit roundoff
NDHWC = torch.channels_last_3d


def _inputs(shape, dtype, bias: bool, seed: int, device="cpu"):
    """x [B, 8, D, H, W] laid out NDHWC, the weight and the bias (or None)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device).to(dtype, memory_format=NDHWC)
    w = (torch.randn((1, 8, 3, 3, 3), generator=g, device=device) * 0.2).to(dtype)
    b = (torch.randn((1,), generator=g, device=device) * 0.1).to(dtype) if bias else None
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("split", [False, True])
def test_wrapper_on_cpu_is_the_module_conv(dtype, bias, split):
    """On a CPU tensor ``prob_conv`` gives ``conv(self.prob, x, sweep)``'s
    bits, unsplit and with a sweep descriptor (a group of one rank: the halo
    planes are zeros), and launches nothing."""
    net = CostRegNet(prob_bias=bias)
    x = torch.randn((2, 8, 5, 7, 9), generator=torch.Generator().manual_seed(1)).to(dtype, memory_format=NDHWC)
    sweep = SimpleNamespace(group=None) if split else None
    kernels.reset_launch_counts()
    got = kp.prob_conv(x, net.prob.weight, net.prob.bias, sweep)
    assert got.dtype == dtype and got.shape == (2, 1, 5, 7, 9)
    assert torch.equal(got, conv(net.prob, x, sweep))
    assert not any(kernels.launch_counts().values())


def test_cost_reg_net_takes_the_wrapper(monkeypatch):
    """CostRegNet's last layer goes through ``prob_conv`` with the module's
    parameters and the sweep descriptor it was given."""
    from scene_3dreconstruction_mvsnet_tpu_torch.models import cost_reg_net

    calls = []

    def spy(x, weight, bias, sweep=None):
        calls.append((tuple(x.shape), weight, bias, sweep))
        return kp.prob_conv(x, weight, bias, sweep)

    monkeypatch.setattr(cost_reg_net, "prob_conv", spy)
    net = CostRegNet(in_channels=8, prob_bias=False).eval()
    with torch.no_grad():
        out = net(torch.randn((1, 8, 8, 8, 8), generator=torch.Generator().manual_seed(2)))
    assert out.shape == (1, 8, 8, 8, 1)
    assert calls == [((1, 8, 8, 8, 8), net.prob.weight, None, None)]


def test_kernel_names_hold_the_prob_conv_kernels():
    assert {"prob_conv", "prob_conv_backward"} <= set(kernels.KERNEL_NAMES)


@pytest.mark.parametrize("kernel", list(kp.TILE_ROWS))
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (1, 192, 144, 200), (1, 48, 216, 288), (1, 32, 432, 576),
                                   (1, 8, 864, 1152), (4, 192, 128, 160), (4, 194, 128, 160), (2, 7, 37, 45),
                                   (3, 5, 17, 33)])
def test_launch_plan_covers_every_output_once(kernel, shape):
    """The tiles cover H x W with less than one tile to spare on each axis,
    the chunks cover D with less than one chunk to spare, a chunk holds at
    least MIN_CHUNK planes (or all of D), and a chunk above MIN_CHUNK keeps
    the grid within TARGET_WARPS warps."""
    B, D, H, W = shape
    tiles_w, tiles_h, chunk, chunks = kp.launch_plan(kernel, B, D, H, W)
    rows = kp.TILE_ROWS[kernel]
    assert (tiles_w - 1) * kp.TILE_COLS < W <= tiles_w * kp.TILE_COLS
    assert (tiles_h - 1) * rows < H <= tiles_h * rows
    assert (chunks - 1) * chunk < D <= chunks * chunk
    assert chunk >= min(D, kp.MIN_CHUNK)
    if chunk > kp.MIN_CHUNK:
        assert B * tiles_w * tiles_h * (chunks - 1) * kp.WARPS[kernel] < kp.TARGET_WARPS


# ---- mirrors of the kernels' loops over D, in f64 --------------------------

def _mirror_forward(x, w, b, pad_d, chunk):
    """prob_forward_kernel's walk: per chunk of output planes, input plane q =
    o0 - pad + p (p < outs + 2; a padding plane skipped) into output o0 + p -
    kd for each kd whose output lies in the chunk."""
    B, _, D_in, H, W = x.shape
    D_out = D_in + 2 * pad_d - 2
    xp = F.pad(x, (1, 1, 1, 1))
    y = torch.zeros((B, 1, D_out, H, W), dtype=x.dtype)
    for o0 in range(0, D_out, chunk):
        outs = min(chunk, D_out - o0)
        for p in range(outs + 2):
            q = o0 - pad_d + p
            if not 0 <= q < D_in:
                continue
            for kd in range(3):
                if not 0 <= p - kd < outs:
                    continue
                for c in range(8):
                    for kh in range(3):
                        for kw in range(3):
                            y[:, 0, o0 + p - kd] += w[0, c, kd, kh, kw] * xp[:, c, q, kh:kh + H, kw:kw + W]
    return y if b is None else y + b


def _mirror_dgrad(g, w, pad_d, D_in, chunk):
    """prob_dgrad_kernel's walk: output plane q = q0 + qi from gradient planes
    q - 2 + pad + a, the taps flipped."""
    B, _, D_out, H, W = g.shape
    gp = F.pad(g, (1, 1, 1, 1))
    gx = torch.zeros((B, 8, D_in, H, W), dtype=g.dtype)
    for q0 in range(0, D_in, chunk):
        for qi in range(min(chunk, D_in - q0)):
            for a in range(3):
                o = q0 - 2 + pad_d + qi + a
                if not 0 <= o < D_out:
                    continue
                for c in range(8):
                    for bh in range(3):
                        for e in range(3):
                            gx[:, c, q0 + qi] += w[0, c, 2 - a, 2 - bh, 2 - e] * gp[:, 0, o, bh:bh + H, e:e + W]
    return gx


def _mirror_wgrad(x, g, pad_d, chunk):
    """prob_wgrad_kernel's walk: stage p of a chunk holds input plane o0 -
    pad + p and gradient plane o0 + p (zeros past the chunk); the gradient
    plane p - kd meets the input plane at tap kd."""
    B, _, D_in, H, W = x.shape
    D_out = g.shape[2]
    xp = F.pad(x, (1, 1, 1, 1))
    dw = torch.zeros((1, 8, 3, 3, 3), dtype=x.dtype)
    db = torch.zeros(1, dtype=x.dtype)
    for o0 in range(0, D_out, chunk):
        outs = min(chunk, D_out - o0)
        for p in range(outs + 2):
            if p < outs:
                db += g[:, 0, o0 + p].sum()
            q = o0 - pad_d + p
            if not 0 <= q < D_in:
                continue
            for kd in range(3):
                if not 0 <= p - kd < outs:
                    continue
                gp = g[:, 0, o0 + p - kd]
                for c in range(8):
                    for kh in range(3):
                        for kw in range(3):
                            dw[0, c, kd, kh, kw] += (gp * xp[:, c, q, kh:kh + H, kw:kw + W]).sum()
    return dw, db


@pytest.mark.parametrize("pad_d", [1, 0])
@pytest.mark.parametrize("chunk", [1, 2, 3, 9])
def test_kernel_loops_over_d_hold_to_conv3d(pad_d, chunk):
    """The three walks, at chunks that split D unevenly, give F.conv3d's
    output and its autograd's three gradients in f64 (1e-12 x the largest)."""
    D_in = 7 + 2 * (1 - pad_d)
    x, w, b = _inputs((2, 8, D_in, 5, 6), torch.float64, True, seed=3)
    x, w, b = x.requires_grad_(), w.requires_grad_(), b.requires_grad_()
    y = kp.prob_conv_plain(x, w, b, pad_d)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    gx, gw, gb = torch.autograd.grad(y, (x, w, b), g)
    with torch.no_grad():
        checks = [(_mirror_forward(x, w, b, pad_d, chunk), y), (_mirror_dgrad(g, w, pad_d, D_in, chunk), gx),
                  *zip(_mirror_wgrad(x, g, pad_d, chunk), (gw, gb))]
    for got, want in checks:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * want.abs().max().item())


def test_cuda_wrapper_refuses_cpu_tensors():
    x, w, b = _inputs((1, 8, 3, 4, 8), torch.float32, True, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kp.prob_conv_cuda(x, w, b, 1)


# ---- on the card ----------------------------------------------------------

# dtu_request's, the cascade's three stages', dtu_train's, and a ragged one
# whose H and W are no multiple of any tile (and whose rows are not 16-byte
# aligned in bf16: the one-value copies)
CARD_SHAPES = [(1, 8, 192, 144, 200), (1, 8, 48, 216, 288), (1, 8, 32, 432, 576), (1, 8, 8, 864, 1152),
               (4, 8, 192, 128, 160), (2, 8, 7, 37, 45)]
FLOOR = 1e-4  # bf16_ulps' floor, x the largest |value|: below it a value is f32 cancellation, not the kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _plain_grads(x, w, b, pad_d, g):
    """The plain version's output and gradients in f32 (TF32 off) from the
    same inputs, upcast."""
    leaves = [t.detach().float().requires_grad_() for t in (x, w) + ((b,) if b is not None else ())]
    y = kp.prob_conv_plain(leaves[0], leaves[1], leaves[2] if b is not None else None, pad_d)
    return (y.detach(), *torch.autograd.grad(y, leaves, g.float()))


def _wgrad64(x, g, pad_d):
    """dw and db in f64 from the same inputs, and the sums of their terms'
    magnitudes: each tap's shifted input times the gradient, summed."""
    B, _, D_in, H, W = x.shape
    D_out = g.shape[2]
    xp = F.pad(x, (1, 1, 1, 1, pad_d, pad_d))
    g64 = g[:, 0].double()
    dw, mag = torch.zeros((8, 27), dtype=torch.float64), torch.zeros((8, 27), dtype=torch.float64)
    for k in range(27):
        kd, kh, kw = k // 9, k // 3 % 3, k % 3
        xs = xp[:, :, kd:kd + D_out, kh:kh + H, kw:kw + W].double()
        dw[:, k] = torch.einsum("bdhw,bcdhw->c", g64, xs).cpu()
        mag[:, k] = torch.einsum("bdhw,bcdhw->c", g64.abs(), xs.abs()).cpu()
        del xs
    return dw.view(1, 8, 3, 3, 3), g64.sum().cpu().view(1), mag.view(1, 8, 3, 3, 3), g64.abs().sum().cpu().view(1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias,pad_d", [(True, 1), (False, 0)])
def test_kernels_match_the_plain_version(cuda, shape, dtype, bias, pad_d):
    """One forward (1 launch) and one backward (3 launches) against the plain
    version of the same inputs (``pad_d`` 0: the split's D + 2 planes in).
    bf16: the output and the input gradient within 1 bf16 ulp of the f32
    plain conv (each rounds an f32 sum once). f32: within two f32 sums' worst
    case of it, 2 (n - 1) 2^-24 x the sum of |terms| (n = 217 terms an
    output, 27 an input gradient). The weight and bias gradients against f64:
    within (8 chunk + 5) 2^-24 x the sum of |terms| (a thread's f32 chain of
    8 chunk terms, then the warp's 5 additions), plus half a bf16 ulp in bf16.
    A second backward repeats the weight gradient's bits."""
    B, C, D, H, W = shape
    x, w, b = _inputs((B, C, D + 2 * (1 - pad_d), H, W), dtype, bias, seed=1, device=cuda)
    x.requires_grad_()
    w.requires_grad_()
    if b is not None:
        b.requires_grad_()
    kernels.reset_launch_counts()
    y = kp.prob_conv_cuda(x, w, b, pad_d)
    assert y.shape == (B, 1, D, H, W) and y.dtype == dtype
    g = torch.randn(y.shape, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda).to(dtype)
    leaves = (x, w) + ((b,) if b is not None else ())
    grads = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert {k: n for k, n in kernels.launch_counts().items() if n} == {"prob_conv": 1, "prob_conv_backward": 3}
    assert all(gr.dtype == dtype for gr in grads)
    assert grads[0].is_contiguous(memory_format=NDHWC)

    want_y, want_gx, *_ = _plain_grads(x, w, b, pad_d, g)
    if dtype == torch.bfloat16:
        assert bf16_ulps(y, want_y, FLOOR * want_y.abs().max().item()) <= 1.0
        assert bf16_ulps(grads[0], want_gx, FLOOR * want_gx.abs().max().item()) <= 1.0
    else:
        wabs = w.detach().abs()
        mag_y = kp.prob_conv_plain(x.detach().abs(), wabs, None if b is None else b.detach().abs(), pad_d)
        assert ((y.detach() - want_y).abs() <= 2 * 216 * U32 * mag_y).all()
        xa = torch.zeros_like(x.detach()).requires_grad_()
        mag_gx = torch.autograd.grad(kp.prob_conv_plain(xa, wabs, None, pad_d), xa, g.abs())[0]
        assert ((grads[0] - want_gx).abs() <= 2 * 26 * U32 * mag_gx).all()

    dw64, db64, mag_w, mag_b = _wgrad64(x.detach(), g, pad_d)
    chunk = kp.launch_plan("wgrad", B, D, H, W)[2]
    rel = (8 * chunk + 5) * U32
    half_ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0  # x |value|: bf16's rounding
    for got, want, mag in [(grads[1], dw64, mag_w)] + ([(grads[2], db64, mag_b)] if b is not None else []):
        err = (got.double().cpu() - want).abs()
        assert (err <= half_ulp * want.abs() + rel * mag).all(), err.max()

    again = torch.autograd.grad(kp.prob_conv_cuda(x, w, b, pad_d), leaves, g)
    assert all(torch.equal(a, c) for a, c in zip(grads[1:], again[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("pad_d", [1, 0])
def test_misaligned_volume_takes_the_one_value_copies(cuda, bias, pad_d):
    """A volume whose address is not 16-byte aligned gives the aligned copy's
    bits, forward and backward (the kernels copy one value at a time
    there)."""
    shape = (1, 8, 6 + 2 * (1 - pad_d), 24, 64)
    x, w, b = _inputs(shape, torch.bfloat16, bias, seed=5, device=cuda)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    flat[1:].copy_(x.permute(0, 2, 3, 4, 1).flatten())
    shifted = flat[1:].view(1, shape[2], 24, 64, 8).permute(0, 4, 1, 2, 3)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous(memory_format=NDHWC)
    w.requires_grad_()
    outs = []
    for xx in (x, shifted):
        xx = xx.detach().requires_grad_()  # the one-value path's gradient is NDHWC too
        y = kp.prob_conv_cuda(xx, w, b, pad_d)
        g = torch.randn(y.shape, generator=torch.Generator(device=cuda).manual_seed(6), device=cuda).to(y.dtype)
        outs.append((y.detach(), *torch.autograd.grad(y, (xx, w), g)))
    for a, c in zip(*outs):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_cost_reg_net_on_the_card_launches_the_kernels(cuda):
    """A bf16 CostRegNet on the card: its prob runs the kernels, one forward
    launch in eval and 1 + 3 in a training step, and cuDNN's f32 engine
    never (the output is the plain network's within bf16 rounding)."""
    net = CostRegNet(in_channels=8, prob_bias=False).to(cuda)
    x = torch.randn((1, 32, 64, 96, 8), generator=torch.Generator(device=cuda).manual_seed(7), device=cuda)
    x = x.to(torch.bfloat16)
    kernels.reset_launch_counts()
    with torch.no_grad():
        net.eval()(x)
    assert kernels.launch_counts()["prob_conv"] == 1
    kernels.reset_launch_counts()
    net.train()(x).float().square().mean().backward()
    counts = kernels.launch_counts()
    assert counts["prob_conv"] == 1 and counts["prob_conv_backward"] == 3
    assert isinstance(net.prob, nn.Conv3d) and net.prob.weight.grad is not None
