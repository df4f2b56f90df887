"""The port's CasMVSNet against the benchmark's plain reference
(``mvsbench/reference/casmvsnet.py``) at a small size on the CPU, with
seeded random weights: every stage, the FPN, the depth hypotheses, the
per-pixel plain sweep and regression, the registry, the spans and the
launch counters. The tests marked ``cuda`` hold K1's and K2's per-pixel
builds to their plain paths and to their per-plane builds on the card, and
run a forward there with no host sync. This file imports nothing of JAX and
runs on the card's machine with ``python -m pytest
tests/test_torch_casmvsnet.py -m cuda --noconftest``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvsbench import scenes
from mvsbench.reference import casmvsnet as ref_cas
from mvsbench.reference.precision import exact
from mvsbench.weights import make_state_dict
from scene_3dreconstruction_mvsnet_tpu_torch import train_cli
from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
from scene_3dreconstruction_mvsnet_tpu_torch.models import (
    CasMVSNet,
    CostRegNet,
    FPNFeatureNet,
    MVSNet,
    find_model_def,
    random_init_,
)
from scene_3dreconstruction_mvsnet_tpu_torch.models.cas_mvsnet import (
    depth_range,
    pixel_planes,
    stage_projection,
    uniform_planes,
)
from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import softmax_regression as k2
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import sweep_variance as k1
from scene_3dreconstruction_mvsnet_tpu_torch.ops.plane_sweep import cost_volume_variance
from scene_3dreconstruction_mvsnet_tpu_torch.ops.regression import regress_depth_and_confidence
from scene_3dreconstruction_mvsnet_tpu_torch.utils import tracing

torch.set_num_threads(1)

NDEPTHS = (16, 8, 8)
SETTING = {"views": 3, "img_hw": [64, 96], "numdepth": 48, "depth_min": 425.0, "depth_interval": 10.0,
           "interval_scale": 1.06}
TRAFFIC = {"pool": 1, "z0_mm": [600.0, 720.0], "slope": 0.15,
           "ring": {"cameras": 7, "radius_mm": 40.0, "height_mm": 0.0, "target_z_mm": 650.0, "focal_over_width": 1.1}}
SPAN = SETTING["numdepth"] * SETTING["depth_interval"] * SETTING["interval_scale"]  # the depth range


def _request(seed):
    req = scenes.request_pool(seed, TRAFFIC, SETTING, "cpu")[0]
    return (torch.as_tensor(req["imgs"]), torch.as_tensor(req["proj_matrices"]), torch.as_tensor(req["depth_values"]))


def _models(seed, dtype=None):
    """The reference and the port with one state dict from ``seed``."""
    ref = ref_cas.CasMVSNet(ndepths=NDEPTHS).eval()
    state = make_state_dict(ref.state_dict(), seed, "cpu")
    ref.load_state_dict(state)
    port = CasMVSNet(dtype=dtype, ndepths=NDEPTHS).eval()
    port.load_state_dict(state)
    return ref, port


def _forward(seed, dtype=None):
    ref, port = _models(seed, dtype)
    imgs, proj, dv = _request(seed)
    with torch.no_grad():
        return ref(imgs.float() / 255, proj, dv), port(imgs.float() / 255, proj, dv)


@pytest.fixture(scope="module")
def f32_outputs():
    return [_forward(seed) for seed in (3, 2147483901)]


def test_find_model_def_gives_casmvsnet():
    assert find_model_def("casmvsnet") is CasMVSNet and find_model_def("mvsnet") is MVSNet


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_casmvsnet_matches_the_reference_in_f32(f32_outputs, stage):
    """Each stage's depth within 1e-3 x the depth range and confidence
    within 1e-4 of the reference (the port's f32 tolerances); stage 3's are
    the outputs."""
    for want, got in f32_outputs:
        assert got[stage]["depth"].shape == want[stage]["depth"].shape
        assert (got[stage]["depth"] - want[stage]["depth"]).abs().max().item() <= 1e-3 * SPAN
        assert (got[stage]["photometric_confidence"] - want[stage]["photometric_confidence"]).abs().max() <= 1e-4
    assert torch.equal(got["depth"], got["stage3"]["depth"])
    assert got["depth"].shape == (1, 64, 96) and got["stage1"]["depth"].shape == (1, 16, 24)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_casmvsnet_in_bf16_is_within_bf16_rounding_of_the_reference(seed):
    """bf16 rounds every conv's input and weight, the volumes and the
    logits: the reference rounded the same way (a witness) moves depth by up
    to 6.3e-4 x the range at this size, the port by up to 9.1e-4 (six
    seeds), so each stage's depth lies within 2e-3 x the range. A pixel whose
    expected plane index sits near an integer may truncate to the next plane
    and its confidence move by up to 0.42, so the confidence is held on its
    mean, within 5e-3 (the port reads up to 1.4e-3)."""
    want, got = _forward(seed, torch.bfloat16)
    for stage in ("stage1", "stage2", "stage3"):
        assert (got[stage]["depth"] - want[stage]["depth"]).abs().max().item() <= 2e-3 * SPAN
        conf = (got[stage]["photometric_confidence"] - want[stage]["photometric_confidence"]).abs()
        assert conf.mean().item() <= 5e-3


def test_the_fpn_matches_the_reference():
    ref, port = _models(4)
    x = torch.rand(2, 32, 48, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = ref.feature(x.permute(0, 3, 1, 2))
        got = port.feature(x)
    assert [tuple(g.shape) for g in got] == [(2, 8, 12, 32), (2, 16, 24, 16), (2, 32, 48, 8)]
    for g, w in zip(got, want):
        assert (g - w.permute(0, 2, 3, 1)).abs().max().item() <= 1e-4 * w.abs().max().item()


def test_the_hypotheses_follow_the_equations():
    """interval = (max - min) / D0 (D0, not D0 - 1); stage 1 spans min..max;
    a later stage spans cur -+ (N / 2) ratio interval in N - 1 steps around
    a depth that is constant over the image, resized without change."""
    dv = torch.from_numpy(np.arange(425.0, 425.0 + 2.65 * 191.5, 2.65, dtype=np.float32))[None]
    assert dv.shape == (1, 192)
    lo, hi, interval = depth_range(dv)
    assert torch.equal(interval, (dv[:, -1] - dv[:, 0]) / 192)
    assert interval.item() == pytest.approx(2.65 * 191 / 192, rel=1e-5)  # D0 - 1 would give 2.65
    planes = uniform_planes(lo, hi, 48)
    assert planes.shape == (1, 48) and planes[0, 0] == lo[0] and planes[0, -1].item() == pytest.approx(hi.item())
    assert torch.allclose(planes[0, 1:] - planes[0, :-1], (hi - lo) / 47, rtol=1e-5)
    cur = torch.full((1, 16, 24), 650.0)
    p = pixel_planes(cur, interval, 32, 2.0, (64, 96), (32, 48))
    assert p.shape == (1, 32, 32, 48)
    half = 32 / 2 * 2.0 * interval.item()
    assert p[0, 0].sub(650.0 - half).abs().max() < 1e-3 and p[0, -1].sub(650.0 + half).abs().max() < 1e-3
    step = p[0, 1:] - p[0, :-1]
    assert torch.allclose(step, torch.full_like(step, 2 * half / 31), rtol=1e-4)


def test_stage_one_takes_the_planes_the_public_code_resizes_exactly():
    """The public code repeats stage 1's planes over the image and resizes
    them trilinearly; that gives the same values, so the port hands K1 the
    [B, N1] planes (its per-plane path)."""
    dv = torch.linspace(425.0, 931.15, 192)[None]
    lo, hi, interval = depth_range(dv)
    public = ref_cas.depth_samples(None, lo, hi, interval, 48, 4.0, (64, 96))
    public = F.interpolate(public[:, None], size=(48, 16, 24), mode="trilinear", align_corners=False)[:, 0]
    assert torch.equal(public, uniform_planes(lo, hi, 48)[:, :, None, None].expand_as(public))


def test_the_port_and_the_reference_build_the_same_later_planes():
    cur = 640.0 + 20.0 * torch.rand(2, 16, 24, generator=torch.Generator().manual_seed(1))
    dv = torch.linspace(425.0, 931.15, 192)[None].repeat(2, 1)
    lo, hi, interval = depth_range(dv)
    up = F.interpolate(cur[:, None], size=(64, 96), mode="bilinear", align_corners=False)[:, 0]
    public = ref_cas.depth_samples(up, lo, hi, interval, 8, 1.0, (64, 96))
    public = F.interpolate(public[:, None], size=(8, 32, 48), mode="trilinear", align_corners=False)[:, 0]
    assert torch.equal(pixel_planes(cur, interval, 8, 1.0, (64, 96), (32, 48)), public)


def test_stage_projection_scales_the_intrinsic_rows():
    proj = torch.randn(1, 3, 4, 4)
    assert stage_projection(proj, 1) is proj
    out = stage_projection(proj, 4)
    assert torch.equal(out[..., :2, :], 4 * proj[..., :2, :]) and torch.equal(out[..., 2:, :], proj[..., 2:, :])


def _sweep_case(C, seed=0):
    g = torch.Generator().manual_seed(seed)
    imgs, proj, dv = _request(5)
    feats = torch.rand(1, 3, 16, 24, C, generator=g)
    return feats, proj, dv[:, ::6]


@pytest.mark.parametrize("depth_chunk", [None, 4])
@pytest.mark.parametrize("C", [32, 16, 8])
def test_the_plain_sweep_per_pixel_equals_per_plane_bits(C, depth_chunk):
    feats, proj, dv = _sweep_case(C)
    per_plane = cost_volume_variance(feats, proj, dv, depth_chunk=depth_chunk)
    per_pixel = cost_volume_variance(feats, proj, dv[:, :, None, None].expand(1, 8, 16, 24).contiguous(),
                                     depth_chunk=depth_chunk)
    assert torch.equal(per_plane, per_pixel)


@pytest.mark.parametrize("C", [32, 16, 8])
def test_the_plain_sweep_per_pixel_matches_the_reference(C):
    feats, proj, dv = _sweep_case(C, 1)
    planes = dv[:, :, None, None] + 30.0 * torch.rand(1, 8, 16, 24, generator=torch.Generator().manual_seed(2))
    got = cost_volume_variance(feats, proj, planes)
    with exact():
        want = ref_cas.variance_volume(feats.permute(0, 1, 4, 2, 3), proj, planes).permute(0, 2, 3, 4, 1)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_the_plain_regression_per_pixel_equals_per_plane_bits():
    g = torch.Generator().manual_seed(3)
    cost = 3.0 * torch.randn(2, 12, 9, 13, generator=g)
    dv = torch.linspace(425.0, 905.0, 12)[None].repeat(2, 1)
    per_plane = regress_depth_and_confidence(cost, dv)
    per_pixel = regress_depth_and_confidence(cost, dv[:, :, None, None].expand(2, 12, 9, 13).contiguous())
    assert torch.equal(per_plane[0], per_pixel[0]) and torch.equal(per_plane[1], per_pixel[1])
    planes = dv[:, :, None, None] + 40.0 * torch.rand(2, 12, 9, 13, generator=g)
    depth, conf = regress_depth_and_confidence(cost, planes)
    assert torch.allclose(depth, (torch.softmax(cost, 1) * planes).sum(1), rtol=1e-6)
    assert torch.equal(conf, per_plane[1])  # the confidence reads plane indices, not depths


def test_one_state_dict_loads_into_the_port_and_the_reference():
    ref, port = ref_cas.CasMVSNet(), CasMVSNet()
    assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == \
           {k: tuple(v.shape) for k, v in port.state_dict().items()}
    state = port.state_dict()
    assert "feature.conv0.0.conv.weight" in state and "feature.inner1.bias" in state
    assert "cost_regularization.2.conv0.conv.weight" in state and "cost_regularization.0.conv7.0.weight" in state
    assert state["cost_regularization.1.conv0.conv.weight"].shape == (8, 16, 3, 3, 3)
    assert not any(k.endswith("prob.bias") for k in state)
    ref.load_state_dict(state, strict=True)


def test_make_state_dict_scales_every_leaf_as_random_init(monkeypatch):
    """The benchmark's weights (``weights.make_state_dict`` over the
    reference's keys) scale each leaf as the port's ``random_init_`` does:
    both maps of a unit draw agree leaf by leaf."""
    from mvsbench import weights

    template = ref_cas.CasMVSNet().state_dict()
    for value in (0.0, 1.0, -1.0):
        monkeypatch.setattr(torch, "randn", lambda shape, generator=None, device=None, v=value: torch.full(
            tuple(shape) if not isinstance(shape, int) else (shape,), v, device=device))
        port = random_init_(CasMVSNet(), torch.Generator()).state_dict()
        made = weights.make_state_dict(template, 0, "cpu")
        for k, v in made.items():
            if v.is_floating_point():
                assert torch.allclose(v, port[k], rtol=1e-6, atol=0), k


def test_cost_reg_net_defaults_are_mvsnets():
    net = CostRegNet()
    assert net.conv0.conv.weight.shape == (8, 32, 3, 3, 3) and net.prob.bias is not None
    assert list(net.state_dict()) == list(MVSNet().cost_regularization.state_dict())
    narrow = CostRegNet(in_channels=8, prob_bias=False)
    assert narrow.conv0.conv.weight.shape == (8, 8, 3, 3, 3) and narrow.prob.bias is None
    with pytest.raises(ValueError, match="32 input channels"):
        CostRegNet(fused_conv0=True, in_channels=16)


def test_training_the_cascade_raises():
    port = CasMVSNet(ndepths=NDEPTHS).train()
    imgs, proj, dv = _request(1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port(imgs.float() / 255, proj, dv)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_cli.main(["--model", "casmvsnet", "--device", "cpu"])


def test_the_serving_entry_records_the_cascade_spans():
    _, port = _models(6)
    tracing.enable()
    try:
        out = make_infer_step(port, "cpu")(*_request(6))
        names = [s["name"] for s in tracing.take()["spans"]]
    finally:
        tracing.disable()
    assert set(out) == {"depth", "photometric_confidence", "stage1", "stage2", "stage3"}
    stage = lambda s: [f"casmvsnet.stage{s}", f"casmvsnet.sweep{s}", f"casmvsnet.costreg{s}"] + \
        ["deconv.parity"] * 3 + [f"casmvsnet.regress{s}"]  # noqa: E731
    assert names == ["infer", "infer.h2d", "casmvsnet.fpn", *stage(1), *stage(2), *stage(3)]


def test_the_launch_counts_split_the_per_pixel_launches(monkeypatch):
    monkeypatch.setattr(k1, "LAUNCHES", 6)
    monkeypatch.setattr(k1, "EMIT_LAUNCHES", 1)
    monkeypatch.setattr(k1, "PER_PIXEL_LAUNCHES", 2)
    monkeypatch.setattr(k2, "LAUNCHES", 3)
    monkeypatch.setattr(k2, "PER_PIXEL_LAUNCHES", 2)
    counts = kernels.launch_counts()
    assert set(counts) == set(kernels.KERNEL_NAMES)
    assert (counts["sweep_variance"], counts["sweep_variance_emit"], counts["sweep_variance_per_pixel"]) == (3, 1, 2)
    assert (counts["softmax_regression"], counts["softmax_regression_per_pixel"]) == (1, 2)
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_NAMES, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _per_pixel_case(device, C, V, H=24, W=72, D=7, seed=0):
    """Features of a ring request and per-pixel planes that wander 30 mm
    about the sweep's planes."""
    g = torch.Generator().manual_seed(seed)
    _, proj, dv = _request(5)
    proj = proj[:, :V] if V <= 3 else torch.cat([proj] + [proj[:, 1:2]] * (V - 3), 1)
    feats = torch.rand(1, V, H, W, C, generator=g)
    planes = torch.linspace(600.0, 720.0, D)[None, :, None, None] + 30.0 * torch.rand(1, D, H, W, generator=g)
    return feats.to(device), proj.to(device), planes.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype,out_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.float32, 2e-3),
    (torch.bfloat16, torch.bfloat16, 1e-2),
])
@pytest.mark.parametrize("C,V", [(32, 5), (16, 5), (8, 5), (8, 3)])
def test_k1_per_pixel_matches_the_plain_path(cuda, C, V, in_dtype, out_dtype, tol):
    feats, proj, planes = _per_pixel_case(cuda, C, V)
    feats = feats.to(in_dtype)
    before = (k1.LAUNCHES, k1.PER_PIXEL_LAUNCHES)
    out = k1.sweep_variance(feats, proj, planes, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (k1.LAUNCHES, k1.PER_PIXEL_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = cost_volume_variance(feats, proj, planes, out_dtype=torch.float32)
    assert out.shape == want.shape and out.dtype == out_dtype
    assert (out.float() - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [32, 16, 8])
def test_k1_per_pixel_with_equal_planes_gives_the_per_plane_bits(cuda, C, dtype):
    feats, proj, _ = _per_pixel_case(cuda, C, 5)
    dv = torch.linspace(600.0, 720.0, 7, device=cuda)[None]
    feats = feats.to(dtype)
    per_plane = k1.sweep_variance(feats, proj, dv)
    per_pixel = k1.sweep_variance(feats, proj, dv[:, :, None, None].expand(1, 7, 24, 72).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(per_plane, per_pixel)
    with pytest.raises(ValueError, match="per plane"):
        k1.sweep_variance(feats, proj, dv[:, :, None, None].expand(1, 7, 24, 72).contiguous(), emit_warps=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,D,H,W", [(1, 8, 27, 36), (1, 32, 13, 9), (2, 48, 7, 33)])
def test_k2_per_pixel_matches_the_plain_path(cuda, B, D, H, W, dtype):
    """Depth within 1e-4 x the planes' span; confidence within 1e-5 except
    where the expected index lies within the paths' disagreement of an
    integer (the truncation may go either way there); equal planes give the
    per-plane launch's bits."""
    g = torch.Generator(device=cuda).manual_seed(D)
    cost = (torch.randn((B, D, H, W), generator=g, device=cuda) * 3.0).to(dtype)
    dv = torch.linspace(600.0, 720.0, D, device=cuda)[None].repeat(B, 1)
    planes = (dv[:, :, None, None] + 30.0 * torch.rand((B, D, H, W), generator=g, device=cuda)).contiguous()
    before = (k2.LAUNCHES, k2.PER_PIXEL_LAUNCHES)
    depth, conf = k2.softmax_regression(cost, planes)
    torch.cuda.synchronize()
    assert (k2.LAUNCHES, k2.PER_PIXEL_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref_depth, ref_conf = regress_depth_and_confidence(cost.float(), planes)
    assert (depth - ref_depth).abs().max().item() <= 1e-4 * 150.0
    index = (torch.softmax(cost.float(), 1) * torch.arange(D, device=cuda)[:, None, None]).sum(1)
    near_int = (index - index.round()).abs() < 1e-4
    assert (conf - ref_conf).abs()[~near_int].max().item() <= 1e-5
    per_plane = k2.softmax_regression(cost, dv)
    per_pixel = k2.softmax_regression(cost, dv[:, :, None, None].expand(B, D, H, W).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(per_plane[0], per_pixel[0]) and torch.equal(per_plane[1], per_pixel[1])


@pytest.mark.cuda
def test_casmvsnet_on_the_card_matches_the_reference_without_a_host_sync(cuda):
    """The forward in f32 on the card (TF32 off) under the sync debug mode
    'error': no host sync; each stage within 1e-3 x the range of the
    reference on the CPU; 3 K1 and 3 K2 launches, 2 of each per pixel."""
    ref, port = _models(7)
    imgs, proj, dv = _request(7)
    args = (imgs.float() / 255, proj, dv)
    with torch.no_grad():
        want = ref(*args)
    port = port.to(cuda)
    dev_args = [a.to(cuda) for a in args]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            got = port(*dev_args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = kernels.launch_counts()
    assert (counts["sweep_variance"], counts["sweep_variance_per_pixel"]) == (1, 2)
    assert (counts["softmax_regression"], counts["softmax_regression_per_pixel"]) == (1, 2)
    for stage in ("stage1", "stage2", "stage3"):
        assert (got[stage]["depth"].cpu() - want[stage]["depth"]).abs().max().item() <= 1e-3 * SPAN
