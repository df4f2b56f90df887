"""The port's training sweep on the CPU, against the JAX package: the plain
warp gradient (the plain version of the warp-backward kernel K3), the plain
emit-warps sweep (the plain version of K1's emit mode), the plain backward
terms (the plain version of K3-terms), the geometry K3's gather takes its
candidate boxes from, and the paired ``torch.autograd.Function`` whose
backward composes them.

On the CPU the kernel wrappers take their plain versions, so these tests
pin the backward formula; the kernels themselves are held against the same
plain versions on the card (tests/test_torch_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu import ops as jops
from scene_3dreconstruction_mvsnet_tpu_torch import ops as tops
from scene_3dreconstruction_mvsnet_tpu_torch.geometry.transforms import plane_sweep_coords
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import paired_grad as k3t
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import sweep_variance as k1
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import warp_grad as k3
from scene_3dreconstruction_mvsnet_tpu_torch.ops.paired_sweep import paired_cost_volume
from tests.test_torch_kernels import camera_among_planes_rig
from tests.test_warp_grad import _rig

torch.set_num_threads(1)

H, W, C, D, V = 16, 40, 32, 4, 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("rot_deg", [0.0, 2.0])
def test_warp_src_feature_grad_matches_jax_vjp(rot_deg):
    """f32, at the bound the JAX package holds its TPU kernel to against
    autodiff (1e-4 x max|ref|)."""
    fea, projs, dv = _rig(H, W, C, D, V=2, rot_deg=rot_deg, seed=1)
    g = np.random.RandomState(2).rand(1, D, H, W, C).astype(np.float32)
    geo = (projs[1][None], projs[0][None], dv[None])

    _, vjp = jax.vjp(lambda x: jops.warp_src_feature(x, *map(jnp.asarray, geo)), jnp.asarray(fea[1][None]))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    before = k3.LAUNCHES
    got = k3.warp_grad(_t(g), *map(_t, geo))
    assert k3.LAUNCHES == before  # a CPU tensor takes the plain version
    torch.testing.assert_close(got, tops.warp_src_feature_grad(_t(g), *map(_t, geo)), rtol=0, atol=0)
    assert got.shape == (1, H, W, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())
    with pytest.raises(ValueError, match="CUDA"):
        k3.warp_grad_cuda(_t(g), k1.homography_terms(_t(projs)), _t(dv[None]))


@pytest.mark.parametrize("depth_chunk", [None, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emitted_warps_match_jax_warp(dtype, depth_chunk):
    """The plain sweep's emit mode: the variance is the one it returns
    without emit, and each emitted view is the JAX warp of that view (on the
    dtype-rounded features), at 1e-4 x max|ref| plus the output dtype's own
    rounding in bf16."""
    fea, projs, dv = _rig(H, W, C, D, V=V, rot_deg=2.0)
    feats = _t(fea[None]).to(dtype)
    var, warps = k1.sweep_variance(feats, _t(projs[None]), _t(dv[None]), depth_chunk=depth_chunk, emit_warps=True)
    torch.testing.assert_close(var, tops.cost_volume_variance(feats, _t(projs[None]), _t(dv[None])), rtol=0, atol=0)
    assert warps.shape == (1, V - 1, D, H, W, C) and warps.dtype == dtype
    f32 = feats.float().numpy()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -8  # + half a bf16 ulp of the largest value
    for v in range(1, V):
        ref = np.asarray(jops.warp_src_feature(
            jnp.asarray(f32[:, v]), jnp.asarray(projs[v][None]), jnp.asarray(projs[0][None]), jnp.asarray(dv[None])
        ))
        np.testing.assert_allclose(warps[:, v - 1].float().numpy(), ref, atol=(tol + 1e-4) * np.abs(ref).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_paired_grad_matches_jax_grad(dtype, tol):
    """PairedCostVolume's feature gradient (plain versions inside) against
    jax.grad of the JAX XLA sweep of the same dtype-rounded features, loss
    sum(vol^2); the tolerances of tests/test_paired_sweep.py (bf16) and
    tests/test_warp_grad.py (f32)."""
    fea, projs, dv = _rig(H, W, C, D, V=V, rot_deg=1.0, seed=3)
    rounded = _t(fea).to(dtype).float().numpy()

    def jloss(f):
        vol = jops.cost_volume_variance(f[None], jnp.asarray(projs)[None], jnp.asarray(dv)[None])
        return jnp.sum(vol * vol)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(rounded)))
    x = _t(fea[None]).to(dtype).requires_grad_(True)
    vol = paired_cost_volume(x, _t(projs[None]), _t(dv[None]))
    assert vol.dtype == dtype
    (vol.float() ** 2).sum().backward()
    assert x.grad.dtype == dtype and x.grad.shape == (1, V, H, W, C)
    np.testing.assert_allclose(x.grad[0].float().numpy(), want, atol=tol * np.abs(want).max())


def test_paired_gives_no_geometry_gradient():
    """The sweep coordinates are constants: projections and depth values
    get no gradient even when they ask for one."""
    fea, projs, dv = _rig(H, W, C, D, V=V, rot_deg=2.0)
    x = _t(fea[None]).requires_grad_(True)
    proj = _t(projs[None]).requires_grad_(True)
    depth = _t(dv[None]).requires_grad_(True)
    paired_cost_volume(x, proj, depth).sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0
    assert proj.grad is None and depth.grad is None


@pytest.mark.parametrize("V", [3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paired_grad_plain_matches_jax_terms(dtype, V):
    """K3-terms' plain version against the JAX paired sweep's backward terms
    (ops/paired_sweep.py, bwd: t_v and dref), computed with jnp from the same
    dtype-rounded inputs; the CPU wrapper takes the plain version and writes
    dref into the buffer it is given."""
    B = 2
    rng = np.random.RandomState(V)
    feats = _t(rng.rand(B, V, H, W, C).astype(np.float32)).to(dtype)
    warps = _t(rng.rand(B, V - 1, D, H, W, C).astype(np.float32)).to(dtype)
    g = _t(rng.randn(B, D, H, W, C).astype(np.float32)).to(dtype)

    def jax_terms(g, w, f):  # the JAX bwd's per-sample body, without the warp transpose
        ref = f[0].astype(jnp.float32)
        wf = w.astype(jnp.float32)
        g32 = g.astype(jnp.float32) * jnp.float32(2.0 / V)
        mean = (ref[None] + wf.sum(0)) * jnp.float32(1.0 / V)
        return g32[None] * (wf - mean[None]), jnp.sum(g32 * (ref[None] - mean), axis=0)

    before = k3t.LAUNCHES
    dref_out = torch.zeros((B, H, W, C), dtype=dtype)
    t, dref = k3t.paired_grad(g, warps, feats, dref_out=dref_out)
    assert k3t.LAUNCHES == before and dref is dref_out and t.dtype == torch.float32 and t.shape == warps.shape
    t_plain, dref_plain = k3t.paired_grad_plain(g, warps, feats)
    torch.testing.assert_close(t, t_plain, rtol=0, atol=0)
    torch.testing.assert_close(dref, dref_plain.to(dtype), rtol=0, atol=0)
    for b in range(B):
        want_t, want_dref = (np.asarray(a) for a in jax_terms(
            *(jnp.asarray(x[b].float().numpy()) for x in (g, warps, feats))))
        np.testing.assert_allclose(t_plain[b].numpy(), want_t, rtol=0, atol=1e-6 * np.abs(want_t).max())
        np.testing.assert_allclose(dref_plain[b].numpy(), want_dref, rtol=0, atol=1e-5 * np.abs(want_dref).max())
    with pytest.raises(ValueError, match="CUDA"):
        k3t.paired_grad_cuda(g, warps, feats)


def _plane_rig(H, W, D):
    """A small version of the training recipe's rig (chip_smoke.py's
    PlaneScene): pinhole cameras 40 mm apart along x, no rotation, the
    reference between its two sources, planes from 425 mm at 2.65 mm x
    (192 / D)."""
    f = 1150.0 / 640.0 * W  # the recipe's focal at its 640-pixel width, scaled to W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    projs = []
    for cam in (1, 2, 0):
        P = np.eye(4)
        P[0, 3] = -40.0 * cam
        P[:3, :4] = K @ P[:3, :4]
        projs.append(P)
    dv = 425.0 + 2.65 * (192 / D) * np.arange(D)
    return np.stack(projs).astype(np.float32), dv.astype(np.float32)


def _candidate_box(inv_maps, q, p, H, W):
    """csrc/warp_grad.cu::candidate_box on flagged planes, in torch: inv_maps
    [..., 9] and source pixels q, p [...] (broadcast) -> the inclusive ref
    ranges (x0, x1, y0, y1)."""
    m = inv_maps.unbind(-1)
    xs, ys = [], []
    for dq in (-1, 1):
        for dp in (-1, 1):
            qc, pc = q + dq, p + dp
            den = m[6] * qc + m[7] * pc + m[8]
            xs.append((m[0] * qc + m[1] * pc + m[2]) / den)
            ys.append((m[3] * qc + m[4] * pc + m[5]) / den)
    xs, ys = torch.stack(xs), torch.stack(ys)
    mg = k3.BOX_MARGIN
    return (torch.ceil((xs.amin(0) - mg).clamp_min(0)), torch.floor((xs.amax(0) + mg).clamp_max(W - 1)),
            torch.ceil((ys.amin(0) - mg).clamp_min(0)), torch.floor((ys.amax(0) + mg).clamp_max(H - 1)))


@pytest.mark.parametrize("rig", ["rot0", "rot2", "plane"])
def test_gather_boxes_hold_every_tap(rig):
    """K3's exactness argument on seeded rigs: on every plane whose flag is
    set (here all of them), each forward sample's taps inside the source
    image lie in the widened candidate box of the tap's pixel, so the gather
    visits every ref pixel that scattered to it. The boxes stay small (a few
    pixels a side), or the gather would not pay."""
    h, w, d = 16, 40, 8
    if rig == "plane":
        projs, dv = _plane_rig(h, w, d)
    else:
        _, projs, dv = _rig(h, w, C, d, V=3, rot_deg=2.0 if rig == "rot2" else 0.0)
    proj, depth = _t(projs), _t(dv)
    inv_maps, ok = k3.gather_geometry(k1.homography_terms(proj), depth[None].repeat(2, 1), h, w)
    assert bool(ok.all())
    for v in (1, 2):
        px, py = plane_sweep_coords(proj[v][None], proj[0][None], depth[None], h, w)  # [1, D, h*w]
        # the forward's coordinate in grid_sample's pixel units, as the plain warp builds it
        ix = (((px / ((w - 1) / 2.0) - 1.0) + 1.0) * w - 1.0) / 2.0
        iy = (((py / ((h - 1) / 2.0) - 1.0) + 1.0) * h - 1.0) / 2.0
        x = torch.arange(h * w) % w
        y = torch.arange(h * w) // w
        seen = 0
        for dx in (0, 1):
            for dy in (0, 1):
                q, p = torch.floor(ix[0]) + dx, torch.floor(iy[0]) + dy  # [D, h*w]
                inside = (q >= 0) & (q < w) & (p >= 0) & (p < h)
                x0, x1, y0, y1 = _candidate_box(inv_maps[v - 1][:, None, :], q, p, h, w)
                held = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
                assert bool(held[inside].all()), f"view {v}: a tap outside its pixel's box"
                assert float(((x1 - x0 + 1) * (y1 - y0 + 1))[inside].max()) <= 36
                seen += int(inside.sum())
        assert seen > d * h * w  # most samples have their taps inside the image


def test_gather_geometry_clears_planes_through_the_source_camera():
    """A plane that the source camera's principal plane cuts inside the
    reference view changes the sign of its map's denominator: its flag is
    clear (K3 walks every ref pixel there), and exactly those planes, found
    here from the cameras in f64 numpy, are; planes wholly behind or wholly in
    front of the source camera keep their flag."""
    _, projs, dv = camera_among_planes_rig()
    H_, W_ = 24, 72
    _, ok = k3.gather_geometry(k1.homography_terms(_t(projs)), _t(dv)[None], H_, W_)
    rel = projs[1].astype(np.float64) @ np.linalg.inv(projs[0].astype(np.float64))
    corners = np.array([[x, y, 1.0] for x in (-1.0, W_) for y in (-1.0, H_)])  # ref pixels, homogeneous
    z = np.stack([(rel[2, :3] @ corners.T) * d + rel[2, 3] for d in dv.astype(np.float64)])  # [D, 4]
    crosses = (z.min(1) < 0) & (z.max(1) > 0)
    assert crosses.any() and not crosses.all() and (z.max(1) < 0).any()  # one behind the camera
    assert ok[0].numpy().tolist() == (~crosses).tolist()
