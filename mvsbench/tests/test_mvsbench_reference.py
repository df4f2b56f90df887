"""The plain reference against the port at tiny sizes on the CPU (f32): the
forward, a train step, and stage B's filter and fusion; and the reference's
imports."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mvsbench import core, scenes
from mvsbench.reference import fusion as ref_fusion
from mvsbench.reference import mvsnet as ref_mvsnet
from mvsbench.reference.precision import rounding
from mvsbench.weights import make_state_dict, stereo_state_dict

from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet
from scene_3dreconstruction_mvsnet_tpu_torch.train import make_optimizer, make_scheduler, make_train_step

SETTING = {"batch": 2, "views": 3, "img_hw": [32, 64], "numdepth": 8, "depth_min": 425.0, "depth_interval": 60.0,
           "interval_scale": 1.06}
TRAFFIC = {"pool": 2, "focal": 80.0, "z0_mm": [600.0, 720.0], "slope": 0.15, "baseline_mm": [3.0, 5.0],
           "ring": {"cameras": 7, "radius_mm": 40.0, "height_mm": 0.0, "target_z_mm": 650.0, "focal_over_width": 1.1}}


def _state(seed=3):
    return make_state_dict(ref_mvsnet.MVSNet().state_dict(), seed, "cpu")


def test_the_reference_and_the_port_share_their_state_dict_keys():
    ref, port = ref_mvsnet.MVSNet().state_dict(), MVSNet().state_dict()
    assert {k: tuple(v.shape) for k, v in ref.items()} == {k: tuple(v.shape) for k, v in port.items()}


@pytest.mark.parametrize("stereo", [False, True])
def test_the_reference_forward_matches_the_port(stereo):
    state = stereo_state_dict(_state(4), 20.0) if stereo else _state()
    req = scenes.request_pool(5, dict(TRAFFIC, pool=1), dict(SETTING, views=4), "cpu")[0]
    args = (torch.as_tensor(req["imgs"]).float() / 255, torch.as_tensor(req["proj_matrices"]),
            torch.as_tensor(req["depth_values"]))
    ref = ref_mvsnet.MVSNet().eval()
    ref.load_state_dict(state)
    port = MVSNet().eval()
    port.load_state_dict(state)
    with torch.no_grad():
        d_ref, c_ref = ref(*args)
        out = port(*args)
    span = SETTING["numdepth"] * SETTING["depth_interval"] * SETTING["interval_scale"]
    assert (out["depth"] - d_ref).abs().max().item() < 1e-5 * span
    assert (out["photometric_confidence"] - c_ref).abs().max().item() < 1e-5


def test_a_reference_train_step_matches_the_port():
    from mvsbench.kinds.train import reference_steps

    torch.manual_seed(0)
    state = _state(7)
    batches = scenes.train_pool(6, TRAFFIC, SETTING, "cpu")[:1]
    losses, grads, change, depth = reference_steps(state, batches, 1e-3, "cpu")
    port = MVSNet()
    port.load_state_dict(state)
    opt = make_optimizer(port, 1e-3)
    step = make_train_step(port, opt, make_scheduler(opt, "10:2", 100), "cpu")
    aux = step({k: torch.as_tensor(v) for k, v in batches[0].items()})
    assert abs(float(aux["loss"]) - losses[0]) < 1e-5 * abs(losses[0])
    assert torch.allclose(aux["depth_est"], depth, rtol=1e-5, atol=1e-3)
    moving = set(core.moving_leaves(grads))
    assert set(grads) - moving == {"cost_regularization.prob.bias"}  # under the softmax: round-off only
    for name, p in port.named_parameters():
        if name not in moving:
            continue
        scale = grads[name].abs().max().item()
        assert (p.grad - grads[name]).abs().max().item() < 1e-3 * scale, name


def test_the_reference_filter_matches_the_port(tmp_path):
    from scene_3dreconstruction_mvsnet_tpu_torch.eval.filtering import fuse_scan
    from scene_3dreconstruction_mvsnet_tpu_torch.geometry.transforms import depth_to_world_points

    rng = np.random.default_rng(0)
    n, H, W = 4, 16, 20
    E = scenes.ring_extrinsics(n, 30.0, 0.0, 400.0)
    K = scenes.intrinsics(22.0, H, W)
    _, depth = scenes.render(np.tile(K, (n, 1, 1)), E, np.tile([[400.0, 0.05, 1.0, 0.0, 0.0]], (n, 1)), H, W, "cpu")
    depths = {v: depth[v].numpy() * (1 + 0.002 * rng.standard_normal((H, W))).astype(np.float32) for v in range(n)}
    confs = {v: rng.uniform(0, 1, (H, W)).astype(np.float32) for v in range(n)}
    pairs = scenes.ring_pairs(n)
    settings = dict(photomask=0.3, geomask=1, condmask_pixel=1.0, condmask_depth=0.01)
    port = fuse_scan(np.stack([depths[v] for v in range(n)]), np.stack([confs[v] for v in range(n)]),
                     np.tile(K, (n, 1, 1)).astype(np.float32), E.astype(np.float32), pairs, list(range(n)),
                     NviewFilter=3, device="cpu", **settings)
    Ks, Es = {v: K for v in range(n)}, {v: E[v] for v in range(n)}
    agree = 0
    for i, (ref, srcs) in enumerate(pairs):
        r = ref_fusion.filter_view(depths, confs, Ks, Es, ref, srcs[:3], device="cpu", **settings)
        for k in ("photo", "geo", "final"):
            assert (port[i][f"{k}_mask"] != r[k]).sum() <= 1
        agree += int(r["final"].sum())
        pts = ref_fusion.back_project(r["fused"], K, E[ref], 1.0531, "cpu")
        want = depth_to_world_points(torch.as_tensor(port[i]["depth_est_averaged"]), torch.as_tensor(K).float(),
                                     torch.as_tensor(E[ref]).float(), xy_scale=1.0531).numpy()
        both = (port[i]["final_mask"] & r["final"]).reshape(-1)
        assert np.abs(pts[both] - want[both]).max() < 1e-3
    assert agree > 0


def test_the_controls_round_coarser_than_f32():
    x = torch.randn(4096, dtype=torch.float64).float() * 3
    errs = {name: (rounding(name)(x) - x).abs().max().item() / x.abs().max().item() for name in ("tf32", "bf16", "fp8")}
    assert 0 < errs["tf32"] <= 2 ** -11 and errs["tf32"] < errs["bf16"] <= 2 ** -8 < errs["fp8"]
    assert rounding(None) is None and rounding("f32") is None


def test_the_reference_imports_nothing_of_the_port_or_jax():
    checkout = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    code = ("import sys, json\n" f"sys.path.insert(0, {checkout!r})\n"
            "import mvsbench.reference.mvsnet, mvsbench.reference.fusion, mvsbench.reference.files, "
            "mvsbench.reference.precision\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (set(core.FORBIDDEN) | {core.PORT}), loaded
