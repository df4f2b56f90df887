"""The BatchNorm3d + ReLU kernels (``ops/kernels/batch_norm.py``), on NDHWC
volumes.

On the CPU: the wrapper's plain version is ``F.batch_norm`` with flax's
running-variance rule and ``F.relu``; a mirror of the kernels' tile
statistics (each tile's per-channel mean and M2, then Chan's combine in the
kernel's order) holds to f64 on ragged tiles and large means; the tile
planner covers every value of an NDHWC volume once. Marked ``cuda``: the
kernels against the plain version and f64 at the cells' full-resolution
shapes. The file imports nothing of JAX, so the card's machine runs it with
``python -m pytest tests/test_torch_batch_norm.py -m cuda --noconftest``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scene_3dreconstruction_mvsnet_tpu_torch.models.blocks import BatchNorm3d
from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import batch_norm as kbn
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import bf16_ulps

torch.set_num_threads(1)
NDHWC = torch.channels_last_3d


def _bn(C: int, seed: int, device="cpu") -> BatchNorm3d:
    """A BatchNorm3d with random affine parameters and running statistics."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm3d(C, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(C, generator=g))
        bn.bias.copy_(torch.randn(C, generator=g) * 0.3)
        bn.running_mean.copy_(torch.randn(C, generator=g) * 0.5)
        bn.running_var.copy_(0.5 + torch.rand(C, generator=g))
        bn.num_batches_tracked.fill_(3)
    return bn.to(device)


def _buffers(bn) -> dict:
    return {k: v.clone() for k, v in bn.named_buffers()}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_wrapper_on_cpu_is_batch_norm_then_relu(training, relu):
    """On a CPU tensor the wrapper, and the module called with ``relu``, give
    ``F.batch_norm`` then ``F.relu`` bit for bit, on the NDHWC layout the
    module takes."""
    x = (torch.randn((2, 4, 3, 5, 6), generator=torch.Generator().manual_seed(1)) * 2.0 + 0.5).to(memory_format=NDHWC)
    bn = _bn(4, 2).train(training)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    want = F.batch_norm(x, rm, rv, bn.weight, bn.bias, training, 0.1, 1e-5)
    want = F.relu(want) if relu else want
    torch.testing.assert_close(kbn.batch_norm_relu(bn, x, relu), want, rtol=0, atol=0)
    bn2 = _bn(4, 2).train(training)
    torch.testing.assert_close(bn2(x, relu=relu), want, rtol=0, atol=0)
    assert kernels.launch_counts()["batch_norm_eval"] == kernels.launch_counts()["batch_norm_train"] == 0


@pytest.mark.parametrize("recomputing", [False, True])
def test_training_updates_the_buffers_by_flax_rule(recomputing):
    """A training forward moves the running mean and the running variance by
    momentum 0.1 towards the batch mean and the biased batch variance, and
    counts the batch; while recomputing, every buffer keeps its bits."""
    x = torch.randn((3, 5, 4, 6, 7), generator=torch.Generator().manual_seed(3), dtype=torch.float64) * 1.5 + 2.0
    bn = _bn(5, 4).double()
    bn.recomputing = recomputing
    before = _buffers(bn)
    y = bn(x, relu=True)
    dims = (0, 2, 3, 4)
    mean, var = x.mean(dims), x.var(dims, unbiased=False)
    want = F.relu((x - mean[:, None, None, None]) / torch.sqrt(var[:, None, None, None] + 1e-5)
                  * bn.weight[:, None, None, None] + bn.bias[:, None, None, None])
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    if recomputing:
        for k, v in bn.named_buffers():
            assert torch.equal(v, before[k]), k
    else:
        torch.testing.assert_close(bn.running_mean, 0.9 * before["running_mean"] + 0.1 * mean, rtol=1e-12, atol=0)
        torch.testing.assert_close(bn.running_var, 0.9 * before["running_var"] + 0.1 * var, rtol=1e-12, atol=0)
        assert int(bn.num_batches_tracked) == int(before["num_batches_tracked"]) + 1


def _tile_map(C: int, V: int, itemsize: int, aligned: bool) -> list[np.ndarray]:
    """The kernels' map of an NDHWC volume of V voxels of C channels
    (``csrc/batch_norm.cu``): chunk t holds voxels t * cv .. (t + 1) * cv - 1
    (the last ragged); thread i is lane g = i % lanes of row r = i // lanes,
    and its pack j holds channels g * vec .. g * vec + vec - 1 of the chunk's
    voxel r + j * rows, loaded where g * vec < C and the voxel is in the
    chunk. Returns each chunk's value indices (voxel * C + channel), in
    (pack, thread, channel) order."""
    vec, lanes, cv = kbn.tile_plan(C, itemsize, aligned)
    rows = kbn.THREADS // lanes
    assert cv == kbn.TILE // kbn.THREADS // vec * rows
    j, i, k = np.meshgrid(np.arange(kbn.TILE // kbn.THREADS // vec), np.arange(kbn.THREADS), np.arange(vec),
                          indexing="ij")
    g, r = i % lanes, i // lanes
    voxel, channel = r + j * rows, g * vec + k
    out = []
    for t in range(-(-V // cv)):
        n = min(cv, V - t * cv)
        loaded = (g * vec < C) & (voxel < n)
        assert (channel[loaded] < C).all()  # a pack lies wholly inside its voxel
        out.append((t * cv + voxel[loaded]) * C + channel[loaded])
    return out


def _block_voxels(b: int, blocks: int, cv: int, V: int) -> int:
    """``block_voxels`` of ``csrc/batch_norm.cu``: block b's chunks b, b +
    blocks, ... are full but the volume's last."""
    chunks = -(-V // cv)
    mine = (chunks - b + blocks - 1) // blocks
    return mine * cv - (chunks * cv - V if (chunks - 1) % blocks == b else 0)


@pytest.mark.parametrize("C,V", [(8, 1), (8, 511), (8, 4097), (16, 10800), (64, 10800), (32, 1000), (48, 777),
                                 (5, 333), (1, 4097)])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_tile_plan_covers_every_value_once(C, V, itemsize, aligned):
    """Every value of an NDHWC volume lies in exactly one chunk's loads, with
    16-byte loads only where a voxel's C values are a multiple of 16 bytes
    and the volumes are aligned, and a voxel's packs on a power of two of
    lanes, the fewest that hold them; the reductions' blocks split the
    voxels as ``block_voxels`` counts them."""
    vec, lanes, cv = kbn.tile_plan(C, itemsize, aligned)
    assert vec == (16 // itemsize if aligned and C * itemsize % 16 == 0 else 1)
    assert lanes & (lanes - 1) == 0 and lanes // 2 < C // vec <= lanes
    chunks = _tile_map(C, V, itemsize, aligned)
    covered = np.sort(np.concatenate(chunks))
    np.testing.assert_array_equal(covered, np.arange(V * C))
    blocks = kbn.reduce_blocks(len(chunks), 1)
    assert blocks == min(len(chunks), kbn.BLOCKS_PER_SM)
    counts = [sum(chunks[t].size for t in range(b, len(chunks), blocks)) // C for b in range(blocks)]
    assert counts == [_block_voxels(b, blocks, cv, V) for b in range(blocks)]


def _tile_statistics(x: np.ndarray, itemsize: int, blocks: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The partial kernel's arithmetic on a [V, C] volume over ``blocks``
    reduction blocks: per block and channel, K the first voxel of its first
    chunk, the f32 sums S1 of d = x - K and S2 of d * d over its chunks b, b
    + blocks, ...; in f64 the mean K + S1 / n and M2 = S2 - S1^2 / n. Returns
    (counts [blocks], means and M2s [C, blocks])."""
    V, C = x.shape
    chunks = _tile_map(C, V, itemsize, True)
    flat = x.reshape(-1)
    counts, means, m2s = [], [], []
    for b in range(blocks):
        idx = np.concatenate(chunks[b::blocks])
        v = flat[idx].astype(np.float32)
        ch, n = idx % C, idx.size // C
        first = flat[chunks[b].min():chunks[b].min() + C].astype(np.float32)
        counts.append(n)
        block_means, block_m2s = [], []
        for c in range(C):
            d = v[ch == c] - first[c]
            s1, s2 = float(d.sum(dtype=np.float32)), float(np.square(d, dtype=np.float32).sum(dtype=np.float32))
            block_means.append(float(first[c]) + s1 / n)
            block_m2s.append(s2 - s1 * (s1 / n))
        means.append(block_means)
        m2s.append(block_m2s)
    return np.array(counts, np.float64), np.array(means).T, np.array(m2s).T


def _chan_combine(counts, means, m2s) -> tuple[float, float]:
    """The finalize kernel's combine in f64: thread i folds entries i,
    i + FINAL_THREADS, ... in turn, then a tree halves the threads. Returns
    (mean, biased variance)."""
    def combine(a, b):
        (na, ma, qa), (nb, mb, qb) = a, b
        if nb == 0:
            return a
        n = na + nb
        d = mb - ma
        return n, ma + d * (nb / n), qa + qb + d * d * (na * nb / n)

    threads = kbn.FINAL_THREADS
    acc = [(0.0, 0.0, 0.0)] * threads
    for e in range(len(counts)):
        acc[e % threads] = combine(acc[e % threads], (counts[e], float(means[e]), float(m2s[e])))
    s = threads // 2
    while s:
        acc = [combine(acc[i], acc[i + s]) for i in range(s)]
        s //= 2
    n, mean, m2 = acc[0]
    return mean, m2 / n


@pytest.mark.parametrize("C,V,blocks", [(8, 4097, 3), (16, 10803, 4), (64, 5 * 64 + 1, 2)])
@pytest.mark.parametrize("offset", [0.0, 1e3])
def test_tile_statistics_hold_to_f64(C, V, blocks, offset):
    """The mirror of the kernels' statistics (per reduction block and channel
    f32 sums of the values shifted by the block's first voxel, over chunks
    strided by the blocks, combined in f64) is within 1e-5 of each channel's
    f64 mean and biased variance over V voxels, with a mean 1000 standard
    deviations from 0 too, where E[x^2] - E[x]^2 in f32 loses every digit."""
    rng = np.random.default_rng(C * V)
    x = (rng.standard_normal((V, C)) * 0.8 + offset).astype(np.float32)
    counts, means, m2s = _tile_statistics(x, 4, blocks)
    assert list(counts) == [_block_voxels(b, blocks, kbn.tile_plan(C, 4, True)[2], V) for b in range(blocks)]
    x64 = x.astype(np.float64)
    for c in range(C):
        mean, var = _chan_combine(counts, means[c], m2s[c])
        want_mean, want_var = x64[:, c].mean(), x64[:, c].var()
        assert abs(mean - want_mean) <= 1e-5 * (abs(want_mean) + np.sqrt(want_var))
        assert abs(var - want_var) <= 1e-5 * want_var
    if offset:
        x32 = x[:, 0]
        naive = np.float32(np.square(x32).mean(dtype=np.float32)) - np.float32(x32.mean(dtype=np.float32)) ** 2
        assert abs(naive - x64[:, 0].var()) > 1e-3 * x64[:, 0].var()  # what the shift avoids


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        kbn.batch_norm_relu_cuda(_bn(2, 0), torch.zeros((1, 2, 1, 1, 8)), True)


def test_tile_plan_refuses_more_packs_than_a_block_has_lanes():
    with pytest.raises(ValueError, match="packs a voxel"):
        kbn.tile_plan(257, 2, True)


# ---- on the card ----------------------------------------------------------

# the cells' full-resolution 8-channel volumes (dtu_request's conv0 / conv11,
# casmvs_dtu_request's stage 3, dtu_train's at B = 4), dtu_request's deepest
# 64-channel level, a small ragged one, one whose 6 packs a voxel leave idle
# lanes, and one of 5 channels that takes the one-value loads
CARD_SHAPES = [(1, 8, 192, 144, 200), (1, 8, 8, 864, 1152), (4, 8, 192, 128, 160), (1, 64, 24, 18, 25),
               (2, 16, 5, 7, 9), (1, 48, 6, 10, 12), (2, 5, 4, 6, 7)]
ZERO_BAND = 1e-6  # a ReLU zero may differ where |pre-activation| < this x the largest (f32 rounding)
FLOOR = 1e-4  # bf16_ulps' floor, x the largest |value|: below it a value is f32 cancellation, not the kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _volume(shape, dtype, device, seed=0):
    """A random [N, C, D, H, W] volume laid out NDHWC."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device) * 1.7 + 0.4
    return x.to(dtype, memory_format=NDHWC)


def _plain(bn, x, relu):
    """The plain version on the card, on copies of bn's buffers."""
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    y = F.batch_norm(x, rm, rv, bn.weight, bn.bias, bn.training, 0.1, bn.eps)
    return F.relu(y) if relu else y


def _pre64(x, mean, invstd, bn):
    s = (-1, 1, 1, 1)
    return ((x.double() - mean.double().view(s)) * invstd.double().view(s) * bn.weight.double().view(s)
            + bn.bias.double().view(s))


def _check_forward(y, want, pre64, relu):
    assert bf16_ulps(y, want, FLOOR * want.float().abs().max().item()) <= 1.0
    if relu:
        differ = (y == 0) != (want == 0)
        assert (pre64[differ].abs() <= ZERO_BAND * pre64.abs().max()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_eval_forward_matches_the_plain_version(cuda, shape, relu, dtype):
    """Eval: one launch, NDHWC out; bf16 within 1 bf16 ulp of
    ``F.batch_norm`` + ``F.relu`` on the card, the ReLU's zeros the same but
    within f32 rounding of 0; f32 within 1e-6 x the largest; two launches
    give equal bits."""
    bn = _bn(shape[1], 5, cuda).eval()
    x = _volume(shape, dtype, cuda)
    kernels.reset_launch_counts()
    with torch.no_grad():
        y = kbn.batch_norm_relu(bn, x, relu)
        again = kbn.batch_norm_relu(bn, x, relu)
        want = _plain(bn, x, relu)
    assert kernels.launch_counts()["batch_norm_eval"] == 2
    assert y.is_contiguous(memory_format=NDHWC)
    invstd = torch.rsqrt(bn.running_var + bn.eps)
    if dtype == torch.bfloat16:
        _check_forward(y, want, _pre64(x, bn.running_mean, invstd, bn), relu)
    else:
        torch.testing.assert_close(y, want, rtol=0, atol=1e-6 * want.abs().max().item())
    assert torch.equal(y, again)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_an_ncdhw_volume(cuda):
    """The kernels take NDHWC only: an NCDHW-contiguous volume is refused
    (``models/blocks.py::to_ndhwc`` converts what a block is handed)."""
    x = _volume((1, 8, 4, 6, 8), torch.bfloat16, cuda).contiguous()
    with pytest.raises(ValueError, match="NDHWC"):
        kbn.batch_norm_relu(_bn(8, 0, cuda).eval(), x, True)


def _f64_reference(bn, x, dy, mask, training):
    """dx, dweight, dbias of ``F.batch_norm`` in f64 (batch statistics in
    training, the running ones in eval) times the kernel's ReLU mask."""
    x64 = x.double().requires_grad_()
    w64, b64 = bn.weight.detach().double().requires_grad_(), bn.bias.detach().double().requires_grad_()
    rm, rv = bn.running_mean.double(), bn.running_var.double()
    y = F.batch_norm(x64, None if training else rm, None if training else rv, w64, b64, training, 0.0, bn.eps)
    (y * mask).backward(dy.double())
    return x64.grad, w64.grad, b64.grad


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_training_forward_and_backward(cuda, shape, dtype):
    """Training: 3 + 3 launches. The batch's mean and invstd within 1e-5 of
    f64 and the running statistics moved by flax's rule; y within 1 ulp of
    the plain version (bf16; f32 within 1e-5 x the largest); dx within 2
    ulps of the f64 gradient of the same inputs under the kernel's ReLU mask
    (each side rounds an f32 or f64 value once, the f32 one summed in another
    order; f32 within 1e-5 relative plus 1e-6 x the largest |dx|, the f32
    rounding of its terms), dgamma and dbeta within 1e-5 of the sum of
    |terms|. A second run gives equal bits."""
    bn = _bn(shape[1], 6, cuda).train()
    x = _volume(shape, dtype, cuda, seed=1).requires_grad_()
    dy = _volume(shape, dtype, cuda, seed=2)
    before = _buffers(bn)
    kernels.reset_launch_counts()
    y = kbn.batch_norm_relu(bn, x, True)
    y.backward(dy)
    assert {k: n for k, n in kernels.launch_counts().items() if n} == {"batch_norm_train": 3,
                                                                      "batch_norm_backward": 3}
    assert y.is_contiguous(memory_format=NDHWC) and x.grad.is_contiguous(memory_format=NDHWC)
    dims = (0, 2, 3, 4)
    x64 = x.detach().double()
    mean64, var64 = x64.mean(dims), x64.var(dims, unbiased=False)
    coef = kbn._forward(x.detach(), _bn(shape[1], 6, cuda).train(), True, keep_coef=True)[1]
    assert ((coef[0].double() - mean64).abs() <= 1e-5 * (mean64.abs() + var64.sqrt())).all()
    invstd64 = torch.rsqrt(var64 + bn.eps)
    assert ((coef[1].double() - invstd64).abs() <= 1e-5 * invstd64).all()
    torch.testing.assert_close(bn.running_mean.double(), 0.9 * before["running_mean"].double() + 0.1 * mean64,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_var.double(), 0.9 * before["running_var"].double() + 0.1 * var64,
                               rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == int(before["num_batches_tracked"]) + 1

    want = _plain(_bn(shape[1], 6, cuda).train(), x.detach(), True)
    pre64 = _pre64(x64, mean64, invstd64, bn)
    if dtype == torch.bfloat16:
        _check_forward(y, want, pre64, True)
    else:
        torch.testing.assert_close(y, want, rtol=0, atol=1e-5 * want.abs().max().item())

    dx64, dw64, db64 = _f64_reference(bn, x.detach(), dy, (y > 0).double(), True)
    if dtype == torch.bfloat16:
        assert bf16_ulps(x.grad, dx64, FLOOR * dx64.abs().max().item()) <= 2.0
    else:
        # dx is a difference of f32 terms as large as the largest |dx|: 1e-6 of that beside 1e-5 relative
        assert ((x.grad.double() - dx64).abs() <= 1e-5 * dx64.abs() + 1e-6 * dx64.abs().max()).all()
    g = dy.double() * (y > 0).double()
    xhat = (x64 - mean64.view(-1, 1, 1, 1)) * invstd64.view(-1, 1, 1, 1)
    assert ((bn.weight.grad.double() - dw64).abs() <= 1e-5 * (g * xhat).abs().sum(dims)).all()
    assert ((bn.bias.grad.double() - db64).abs() <= 1e-5 * g.abs().sum(dims)).all()

    first = (y.detach().clone(), x.grad.clone(), bn.weight.grad.clone(), bn.bias.grad.clone())
    x.grad = bn.weight.grad = bn.bias.grad = None
    y2 = kbn.batch_norm_relu(bn, x, True)
    y2.backward(dy)
    for a, b in zip(first, (y2.detach(), x.grad, bn.weight.grad, bn.bias.grad)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
def test_eval_backward_and_recompute(cuda, relu):
    """Eval with gradients: dx = scale * g; dgamma and dbeta as the f64
    gradient. A training forward while recomputing leaves every buffer's
    bits. A cotangent in another layout (a strided view) gives the NDHWC
    one's bits."""
    shape = (2, 16, 12, 18, 20)
    bn = _bn(16, 7, cuda).eval()
    x = _volume(shape, torch.bfloat16, cuda, seed=3).requires_grad_()
    dy_full = _volume((2, 16, 12, 18, 40), torch.bfloat16, cuda, seed=4)
    dy = dy_full[..., ::2]
    y = kbn.batch_norm_relu(bn, x, relu)
    y.backward(dy)
    mask = (y > 0).double() if relu else torch.ones_like(y, dtype=torch.float64)
    dx64, dw64, db64 = _f64_reference(bn, x.detach(), dy, mask, False)
    assert bf16_ulps(x.grad, dx64, FLOOR * dx64.abs().max().item()) <= 1.0
    torch.testing.assert_close(bn.weight.grad.double(), dw64, rtol=1e-5, atol=1e-5 * dw64.abs().max().item())
    torch.testing.assert_close(bn.bias.grad.double(), db64, rtol=1e-5, atol=1e-5 * db64.abs().max().item())
    first = x.grad.clone()
    x.grad = None
    kbn.batch_norm_relu(bn, x, relu).backward(dy.contiguous(memory_format=NDHWC))
    assert torch.equal(first, x.grad)

    bn.train()
    bn.recomputing = True
    before = _buffers(bn)
    kbn.batch_norm_relu(bn, x.detach(), relu)
    for k, v in bn.named_buffers():
        assert torch.equal(v, before[k]), k


@pytest.mark.cuda
def test_misaligned_volume_takes_the_one_value_loads(cuda):
    """A volume whose address is not 16-byte aligned gives the aligned
    copy's bits (the kernels load one value at a time there)."""
    shape = (1, 8, 16, 24, 32)
    bn = _bn(8, 8, cuda).eval()
    x = _volume(shape, torch.bfloat16, cuda, seed=5)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    flat[1:].copy_(x.permute(0, 2, 3, 4, 1).flatten())
    shifted = flat[1:].view(1, 16, 24, 32, 8).permute(0, 4, 1, 2, 3)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous(memory_format=NDHWC)
    with torch.no_grad():
        assert torch.equal(kbn.batch_norm_relu(bn, shifted, True), kbn.batch_norm_relu(bn, x, True))


@pytest.mark.cuda
def test_batch_norm_2d_stays_on_torch(cuda):
    """BatchNorm2d (FeatureNet's, channels-last input) launches none of the
    kernels."""
    from scene_3dreconstruction_mvsnet_tpu_torch.models.blocks import BatchNorm2d

    bn = BatchNorm2d(8).to(cuda).eval()
    kernels.reset_launch_counts()
    with torch.no_grad():
        bn(torch.randn((1, 8, 16, 16), device=cuda).to(memory_format=torch.channels_last), relu=True)
    assert not any(kernels.launch_counts().values())
