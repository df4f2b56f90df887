"""The port's Hopper kernels against their plain PyTorch versions. They need
an NVIDIA GPU (and nvcc): marked ``cuda``, they skip elsewhere.
The machine with the card has no JAX, which tests/conftest.py imports, so
this file imports nothing of JAX and runs there with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``."""

import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu_torch.ops import (
    cost_volume_variance,
    regress_depth_and_confidence,
    warp_src_feature,
    warp_src_feature_grad,
)
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import bf16_ulps
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import paired_grad as k3t
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import softmax_regression as k2
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import sweep_variance as k1
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import warp_grad as k3
from scene_3dreconstruction_mvsnet_tpu_torch.ops.paired_sweep import paired_cost_volume

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _rig(H, W, C, D, V, rot_deg):
    """Random features and a translated rig whose views turn by ``rot_deg``
    each (the rig of tests/test_sweep_variance.py)."""
    rng = np.random.RandomState(0)
    fea = rng.rand(V, H, W, C).astype(np.float32)
    K = np.array([[0.7 * W, 0, W / 8], [0, 0.7 * W, H / 8], [0, 0, 1]], np.float32)
    projs = []
    for v in range(V):
        a = np.deg2rad(rot_deg * v)
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        E[0, 3], E[1, 3] = -2.0 * v, 0.3 * v
        P = E.copy()
        P[:3, :4] = K @ E[:3, :4]
        projs.append(P)
    return fea, np.stack(projs), np.linspace(425.0, 905.0, D, dtype=np.float32)


def camera_among_planes_rig(H=24, W=72, C=32):
    """Features, projections [2, 4, 4] and 7 planes (425 ... 905) of a rig
    whose source camera stands among the planes: centred at depth 650 and
    turned 5 degrees about y. Its principal plane cuts the plane at 665
    inside the reference view, so that plane's pixel homography changes the
    sign of its denominator (``gather_geometry`` clears its flag and K3 walks
    every ref pixel); the planes at 425-585 lie wholly behind the source
    camera and 745-905 wholly in front, and their maps keep one sign."""
    rng = np.random.RandomState(5)
    fea = rng.rand(2, H, W, C).astype(np.float32)
    K = np.array([[0.7 * W, 0, W / 8], [0, 0.7 * W, H / 8], [0, 0, 1]], np.float32)
    a = np.deg2rad(5.0)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    E[:3, 3] = -E[:3, :3] @ np.array([0.0, 0.0, 650.0], np.float32)
    projs = np.stack([np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)])
    projs[0, :3, :4] = K @ np.eye(4, dtype=np.float32)[:3, :4]
    projs[1, :3, :4] = K @ E[:3, :4]
    return fea, projs, np.linspace(425.0, 905.0, 7, dtype=np.float32)


def _batch(B, H, W, C, D, V, rot_deg):
    """``_rig`` as a batch of B samples on the device layout: sample b's
    features are 1 - those of sample b - 1 (so a sample mix-up shows), the
    same cameras and planes."""
    fea, projs, dv = _rig(H, W, C, D, V, rot_deg)
    feats = np.stack([fea if b % 2 == 0 else 1.0 - fea for b in range(B)])
    return feats, np.stack([projs] * B), np.stack([dv] * B)


# rigs: no turn, a 2 degree turn per view, and a 25 degree turn whose
# footprints leave the source images; D = 7 is not a multiple of K1's plane
# chunk (4 at these sizes)
RIGS = [(1, 0.0), (1, 2.0), (2, 2.0), (1, 25.0)]
# K1's builds: the model's (C = 32, at most 4 source views: the lanes of a
# pixel share the coordinates) and the general one (any C and view count,
# rays recomputed per plane): (views added to the test's own, channels), so
# the variance tests take 4, 7 or 18 views and the emit tests 3, 6 or 17
K1_BUILDS = [(0, 32), (3, 16), (14, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("in_dtype,out_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.float32, 2e-3),
    (torch.bfloat16, torch.bfloat16, 1e-2),  # + the output's own bf16 rounding
])
@pytest.mark.parametrize("B,rot_deg", RIGS)
@pytest.mark.parametrize("extra_views,C", K1_BUILDS)
def test_sweep_variance_kernel_matches_plain(cuda, extra_views, C, B, rot_deg, in_dtype, out_dtype, tol):
    V = 4 + extra_views
    fea, projs, dv = _batch(B, 24, 72, C, 7, V, rot_deg=rot_deg)
    feats = torch.from_numpy(fea).to(cuda, in_dtype)
    proj = torch.from_numpy(projs).to(cuda)
    depth = torch.from_numpy(dv).to(cuda)
    before = k1.LAUNCHES
    out = k1.sweep_variance(feats, proj, depth, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + B and out.dtype == out_dtype and out.shape == (B, 7, 24, 72, C)
    ref = cost_volume_variance(feats, proj, depth, out_dtype=torch.float32)
    scale = ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol * scale


def _logits(cuda, B, D, H, W, dtype):
    gen = torch.Generator(device=cuda).manual_seed(D)
    cost = (torch.randn((B, D, H, W), generator=gen, device=cuda) * 3.0).to(dtype)
    return cost, torch.linspace(425.0, 905.0, D, device=cuda)[None].repeat(B, 1)


def _check_regression(cost, dv, depth, conf):
    """K2's maps against the plain path on the logits in f32: depth within
    1e-4 x the depth range; confidence within 1e-5 except where the expected
    index lies within the two paths' depth disagreement (plus 1e-4) of an
    integer, where its truncation may go either way."""
    D = dv.shape[1]
    ref_depth, ref_conf = regress_depth_and_confidence(cost.float(), dv)
    d_diff = (depth - ref_depth).abs()
    assert d_diff.max().item() <= 1e-4 * 480.0
    e_idx = (ref_depth - 425.0) * ((D - 1) / 480.0)
    near_int = (e_idx - e_idx.round()).abs() < d_diff * ((D - 1) / 480.0) + 1e-4
    assert (~near_int).any()
    assert (conf - ref_conf).abs()[~near_int].max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,D,H,W", [(2, 192, 20, 36), (1, 5, 13, 9), (2, 200, 7, 33), (1, 192, 9, 37)])
def test_softmax_regression_kernel_matches_plain(cuda, B, D, H, W, dtype):
    """K2 on f32 and bf16 logits against the plain path; the sizes cut the
    32-pixel tiles raggedly, odd H*W takes the element-wise staging, and D
    is not a multiple of the 4 slices."""
    cost, dv = _logits(cuda, B, D, H, W, dtype)
    before = k2.LAUNCHES
    depth, conf = k2.softmax_regression(cost, dv)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1 and depth.shape == conf.shape == (B, H, W)
    _check_regression(cost, dv, depth, conf)


@pytest.mark.parametrize("B,D,H,W", [(2, 192, 20, 36), (1, 5, 13, 9), (2, 200, 7, 33)])
def test_softmax_regression_kernel_bf16_equals_f32_bits(cuda, B, D, H, W):
    """bf16 logits and the same values in f32 go through the same f32
    arithmetic in the same order: the same bits."""
    cost, dv = _logits(cuda, B, D, H, W, torch.bfloat16)
    got = k2.softmax_regression(cost, dv)
    want = k2.softmax_regression(cost.float(), dv)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W", [(20, 36), (13, 9)])
def test_softmax_regression_kernel_takes_strided_logits(cuda, H, W, dtype):
    """Logits strided over B and D (every other sample, planes 1..D of a
    larger volume; 16-byte aligned rows at 20 x 36, element-wise staging at
    13 x 9) give the bits of their contiguous copy; pixels that are not
    contiguous within a plane are refused."""
    big, _ = _logits(cuda, 4, 195, H, W, dtype)
    cost = big[::2, 1:193]
    dv = torch.linspace(425.0, 905.0, 192, device=cuda)[None].repeat(2, 1)
    got = k2.softmax_regression(cost, dv)
    want = k2.softmax_regression(cost.contiguous(), dv)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _check_regression(cost, dv, *got)
    with pytest.raises(ValueError, match="contiguous"):
        k2.softmax_regression(big[:2, :192].transpose(2, 3), dv)


def test_kernels_refuse_what_they_do_not_take(cuda):
    feats = torch.zeros((1, 2, 8, 8, 12), device=cuda)  # channels not a multiple of 8
    proj = torch.eye(4, device=cuda).repeat(1, 2, 1, 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        k1.sweep_variance(feats, proj, torch.ones((1, 3), device=cuda))
    with pytest.raises(ValueError, match="multiple of 8"):
        k3.warp_grad(torch.zeros((1, 3, 8, 8, 12), device=cuda), proj[:, 1], proj[:, 0], torch.ones((1, 3), device=cuda))
    with pytest.raises(ValueError, match="multiple of 8"):
        k3t.paired_grad(torch.zeros((1, 3, 8, 8, 12), device=cuda), torch.zeros((1, 1, 3, 8, 8, 12), device=cuda),
                        feats)
    with pytest.raises(TypeError):
        k2.softmax_regression(torch.zeros((1, 4, 2, 2), device=cuda, dtype=torch.float16),
                              torch.ones((1, 4), device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,rot_deg", RIGS)
@pytest.mark.parametrize("extra_views,C", K1_BUILDS)
def test_sweep_variance_emit_matches_plain(cuda, extra_views, C, B, rot_deg, dtype):
    """K1's emit mode: the variance is bit-identical to the launch without
    emit; each emitted view equals the plain warp exactly in f32 and within
    one bf16 ulp in bf16."""
    V = 3 + extra_views
    fea, projs, dv = _batch(B, 24, 72, C, 7, V, rot_deg=rot_deg)
    feats = torch.from_numpy(fea).to(cuda, dtype)
    proj = torch.from_numpy(projs).to(cuda)
    depth = torch.from_numpy(dv).to(cuda)
    before, before_emit = k1.LAUNCHES, k1.EMIT_LAUNCHES
    var, warps = k1.sweep_variance(feats, proj, depth, emit_warps=True)
    plain_var = k1.sweep_variance(feats, proj, depth)
    torch.cuda.synchronize()
    assert (k1.LAUNCHES, k1.EMIT_LAUNCHES) == (before + 2 * B, before_emit + B)
    assert warps.shape == (B, V - 1, 7, 24, 72, C) and warps.dtype == dtype
    torch.testing.assert_close(var, plain_var, rtol=0, atol=0)
    # one sample at a time, as K1 takes them: the plain warp of a batch computes
    # its homographies batched, which rounds differently in the last bit
    for b in range(B):
        for v in range(V - 1):
            ref = warp_src_feature(feats[b:b + 1, v + 1], proj[b:b + 1, v + 1], proj[b:b + 1, 0],
                                   depth[b:b + 1]).float()
            if dtype == torch.float32:
                assert (warps[b:b + 1, v].float() - ref).abs().max().item() == 0.0
            else:
                assert bf16_ulps(warps[b:b + 1, v], ref) <= 1.0


def _warp_grad_pairs(cuda, fea_projs_dv, rng_seed):
    """K3 for the rig's source views as one launch of pairs, and the plain
    version for each pair: (out, again, plain, LAUNCHES added)."""
    _, projs, dv = fea_projs_dv
    n, (D,) = projs.shape[0] - 1, dv.shape
    proj = torch.from_numpy(projs).to(cuda)
    depth = torch.from_numpy(dv).to(cuda)[None].repeat(n, 1)
    H, W, C = fea_projs_dv[0].shape[1:]
    g = torch.from_numpy(np.random.RandomState(rng_seed).randn(n, D, H, W, C).astype(np.float32)).to(cuda)
    src, ref = proj[1:], proj[:1].repeat(n, 1, 1)
    before = k3.LAUNCHES
    out = k3.warp_grad(g, src, ref, depth)
    again = k3.warp_grad(g, src, ref, depth)
    torch.cuda.synchronize()
    plain = torch.cat([warp_src_feature_grad(g[i:i + 1], src[i:i + 1], ref[i:i + 1], depth[i:i + 1]) for i in range(n)])
    return out, again, plain, k3.LAUNCHES - before


@pytest.mark.parametrize("H,W,C,D", [(24, 72, 32, 7), (9, 37, 32, 5), (11, 26, 16, 6)])
@pytest.mark.parametrize("rot_deg", [0.0, 2.0])
def test_warp_grad_kernel_matches_plain(cuda, rot_deg, H, W, C, D):
    """K3 (the gather) for two (sample, source view) pairs in one launch
    against grid_sample's backward, at the bound the JAX package holds its
    TPU kernel to against autodiff (1e-4 x max|plain|); two launches give the
    same bits. The sizes cut the blocks and the plane slices raggedly, and
    C = 16 takes the build whose lanes do not share the candidates."""
    out, again, plain, launches = _warp_grad_pairs(cuda, _rig(H, W, C, D, 3, rot_deg=rot_deg), 2)
    assert launches == 2 and out.shape == (2, H, W, C) and out.dtype == torch.float32
    assert torch.equal(out, again)
    assert (out - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


def test_warp_grad_kernel_on_planes_through_the_source_camera(cuda):
    """A plane whose map changes the sign of its denominator is flagged and
    walked whole, and K3 stays exact there and on the planes behind the
    source camera."""
    rig = camera_among_planes_rig()
    homography = k1.homography_terms(torch.from_numpy(rig[1]).to(cuda))
    _, ok = k3.gather_geometry(homography, torch.from_numpy(rig[2]).to(cuda)[None], 24, 72)
    assert ok.tolist() == [[True, True, True, False, True, True, True]]
    out, again, plain, launches = _warp_grad_pairs(cuda, rig, 3)
    assert launches == 2 and torch.equal(out, again)
    assert (out - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.parametrize("layout", ["contiguous", "ncdhw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [3, 4, 5])
def test_paired_grad_kernel_matches_plain(cuda, V, dtype, layout):
    """K3-terms against its plain version: t bit for bit where the view sum
    has two terms (V = 3), else within 1e-6 x max|plain| (the sum's order);
    dref within 1e-4 x max|plain| (another order over the planes), the same
    from launch to launch. The volume's cotangent comes contiguous or in the
    conv's NCDHW layout, as the train step hands it over; 9 x 37 pixels and
    7 planes cut the blocks and the plane slices raggedly."""
    B, D, H, W, C = 2, 7, 9, 37, 32
    rng = np.random.RandomState(V)
    feats = torch.from_numpy(rng.rand(B, V, H, W, C).astype(np.float32)).to(cuda, dtype)
    warps = torch.from_numpy(rng.rand(B, V - 1, D, H, W, C).astype(np.float32)).to(cuda, dtype)
    g = torch.from_numpy(rng.randn(B, D, H, W, C).astype(np.float32)).to(cuda, dtype)
    if layout == "ncdhw":
        g = g.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    before = k3t.LAUNCHES
    t, dref = k3t.paired_grad(g, warps, feats)
    _, dref2 = k3t.paired_grad(g, warps, feats)
    torch.cuda.synchronize()
    assert k3t.LAUNCHES == before + 2 and t.shape == warps.shape and t.dtype == dref.dtype == torch.float32
    t_plain, dref_plain = k3t.paired_grad_plain(g, warps, feats)
    if V == 3:
        assert torch.equal(t, t_plain)
    else:
        assert (t - t_plain).abs().max().item() <= 1e-6 * t_plain.abs().max().item()
    assert torch.equal(dref, dref2)
    assert (dref - dref_plain).abs().max().item() <= 1e-4 * dref_plain.abs().max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_paired_cost_volume_grad_matches_plain(cuda, dtype, tol):
    """The paired sweep (K1 emit forward; K3-terms and K3 backward, one
    launch each for the batch of two) against autograd through the plain f32
    sweep of the same (dtype-rounded) features; two backward passes give the
    same bits."""
    fea, projs, dv = _batch(2, 24, 72, 32, 7, 3, rot_deg=2.0)
    feats = torch.from_numpy(fea).to(cuda, dtype)
    proj = torch.from_numpy(projs).to(cuda)
    depth = torch.from_numpy(dv).to(cuda)
    G = torch.from_numpy(np.random.RandomState(3).rand(2, 7, 24, 72, 32).astype(np.float32)).to(cuda)
    x = feats.clone().requires_grad_(True)
    before = (k3t.LAUNCHES, k3.LAUNCHES)
    (got,) = torch.autograd.grad((paired_cost_volume(x, proj, depth).float() * G).sum(), x)
    assert (k3t.LAUNCHES, k3.LAUNCHES) == (before[0] + 1, before[1] + 1)
    (again,) = torch.autograd.grad((paired_cost_volume(x, proj, depth).float() * G).sum(), x)
    x32 = feats.float().requires_grad_(True)
    (want,) = torch.autograd.grad((cost_volume_variance(x32, proj, depth) * G).sum(), x32)
    assert got.dtype == dtype and torch.equal(got, again)
    assert (got.float() - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.parametrize("shape", [(1, 5, 8, 32), (2, 6, 7, 19), (1, 3, 9, 37), (2, 1, 8, 33), (1, 2, 10, 40),
                                   (2, 13, 16, 64)])
def test_conv0_fused_kernel_matches_plain(cuda, shape):
    """K4 against its plain version (f32 conv of the same bf16-rounded
    inputs, TF32 off): the same exact products summed in another order, so at
    most one bf16 ulp apart. Near ReLU's kink a value may round to 0 on one
    side, so the ulp is taken at no less than 1e-3 x max|plain| (the f32 sums'
    order noise is ~1e-6 of it). The shapes cut the 8 x 32 output tile and
    the plane chunks raggedly (D = 1, 2 and 13 = 3 x 4 + 1 planes)."""
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import conv0_fused as k4

    B, D, H, W = shape
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(B, D, H, W, 32).astype(np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy((rng.rand(8, 32, 3, 3, 3) - 0.5).astype(np.float32)).to(cuda)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.uniform(-2.0, 0.5, 8).astype(np.float32)).to(cuda)
    before = k4.LAUNCHES
    out = k4.conv0_bn_relu(x, w, scale, bias)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1 and out.dtype == torch.bfloat16 and out.shape == (B, 8, D, H, W)
    ref = k4.conv0_bn_relu_plain(x, w, scale, bias)
    assert bool((ref == 0).any()) and bool((ref > 0).any())  # both sides of the ReLU are seen
    assert bf16_ulps(out, ref, floor=1e-3 * ref.float().abs().max().item()) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rot_deg", [0.0, 2.0, 25.0])
@pytest.mark.parametrize("C,D", [(32, 7), (16, 7), (32, 19)])
def test_plane_sweep_warp_kernel_matches_plain(cuda, C, D, rot_deg, dtype):
    """K5 against the plain warp: equal in f32, within one bf16 ulp (0 is
    expected: the kernel samples as K1-emit does) in bf16. C = 32 takes the
    build whose 4 lanes split each step of 4 planes' coordinates, C = 16 the
    general one; 7 and 19 planes end the plane chunks (4 planes at these
    sizes) and the steps raggedly; the 25 degree rig leaves the image."""
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import plane_sweep_warp as k5

    fea, projs, dv = _rig(24, 72, C, D, 2, rot_deg=rot_deg)
    src = torch.from_numpy(fea[1]).to(cuda, dtype)[None]
    proj = torch.from_numpy(projs).to(cuda)
    depth = torch.from_numpy(dv).to(cuda)[None]
    before = k5.LAUNCHES
    out = k5.plane_sweep_warp(src, proj[None, 1], proj[None, 0], depth)
    torch.cuda.synchronize()
    assert k5.LAUNCHES == before + 1 and out.dtype == dtype and out.shape == (1, D, 24, 72, C)
    ref = warp_src_feature(src, proj[None, 1], proj[None, 0], depth)
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() == 0.0
    else:
        assert bf16_ulps(out, ref) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rot_deg", [2.0, 25.0])
@pytest.mark.parametrize("C", [32, 16])
def test_plane_sweep_warp_kernel_equals_k1_emit_warps(cuda, C, rot_deg, dtype):
    """K5's volume of each source view equals, bit for bit, the warp K1
    emits for that view from the same features."""
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import plane_sweep_warp as k5

    fea, projs, dv = _rig(24, 72, C, 9, 4, rot_deg=rot_deg)
    feats = torch.from_numpy(fea).to(cuda, dtype)
    proj = torch.from_numpy(projs).to(cuda)
    depth = torch.from_numpy(dv).to(cuda)
    _, warps = k1.sweep_variance_cuda(feats, proj, depth, emit_warps=True)
    for v in range(1, 4):
        assert torch.equal(k5.plane_sweep_warp_cuda(feats[v], proj[v], proj[0], depth), warps[v - 1])


def test_sweep_variance_kernel_at_the_legacy_dtu_shape(cuda):
    """K1 in f32 at evaldtu_cli's shape: features [5, 296, 400, 32] (1184 x
    1600 images) -> [192, 296, 400, 32] f32, 2.9 GB, whose element offsets
    pass 2^29 and byte offsets 2^31; against the plain sweep at 1e-4 x
    max|ref|."""
    fea, projs, dv = _rig(296, 400, 32, 192, 5, rot_deg=2.0)
    feats = torch.from_numpy(fea).to(cuda)[None]
    proj = torch.from_numpy(projs).to(cuda)[None]
    depth = torch.from_numpy(dv).to(cuda)[None]
    before = k1.LAUNCHES
    out = k1.sweep_variance(feats, proj, depth)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1 and out.dtype == torch.float32 and out.shape == (1, 192, 296, 400, 32)
    ref = cost_volume_variance(feats, proj, depth, depth_chunk=24)
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_softmax_regression_kernel_at_the_legacy_dtu_shape(cuda):
    """K2 on f32 logits [1, 192, 296, 400] (118,400 pixels: 3,700 tiles of
    32) against the plain path."""
    cost, dv = _logits(cuda, 1, 192, 296, 400, torch.float32)
    before = k2.LAUNCHES
    depth, conf = k2.softmax_regression(cost, dv)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1 and depth.shape == conf.shape == (1, 296, 400)
    _check_regression(cost, dv, depth, conf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plane_sweep_warp_kernel_at_the_recipe_shape(cuda, dtype):
    """K5 at the training recipe's dump shape: one source view [128, 160, 32]
    -> [192, 128, 160, 32], equal to the plain warp in f32 and within one
    bf16 ulp in bf16, and bit for bit K1-emit's warp of that view."""
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import plane_sweep_warp as k5

    fea, projs, dv = _rig(128, 160, 32, 192, 3, rot_deg=2.0)
    feats = torch.from_numpy(fea).to(cuda, dtype)
    proj = torch.from_numpy(projs).to(cuda)
    depth = torch.from_numpy(dv).to(cuda)
    before = k5.LAUNCHES
    out = k5.plane_sweep_warp(feats[None, 1], proj[None, 1], proj[None, 0], depth[None])
    torch.cuda.synchronize()
    assert k5.LAUNCHES == before + 1 and out.shape == (1, 192, 128, 160, 32)
    ref = warp_src_feature(feats[None, 1], proj[None, 1], proj[None, 0], depth[None])
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() == 0.0
    else:
        assert bf16_ulps(out, ref) <= 1.0
    _, warps = k1.sweep_variance_cuda(feats, proj, depth, emit_warps=True)
    assert torch.equal(out[0], warps[0])
