"""The port's R-MVSNet against the benchmark's plain reference
(``mvsbench/reference/rmvsnet.py``) at a small size on the CPU (3 views at
64x80, 16 planes, K1 chunks of 4 and of 6, the second leaving a remainder),
with seeded random weights: the GRU cell against its equations, the whole
model in f32 and in bf16, the winner-take-all pass, the reference's faults,
the state dict, the registry and the CLIs' refusals, the spans and the launch
counts. The tests marked ``cuda`` run the forward on the card against the
reference on the CPU, with no host sync, and serve the DTU test setting
there. This file imports nothing of JAX and runs on the card's machine with
``python -m pytest tests/test_torch_rmvsnet.py -m cuda --noconftest``."""

import math

import pytest
import torch
import torch.nn.functional as F

from mvsbench import scenes
from mvsbench.reference import rmvsnet as ref_rmvs
from mvsbench.reference.precision import rounding
from mvsbench.weights import make_state_dict
from scene_3dreconstruction_mvsnet_tpu_torch import eval_cli, evaldtu_cli, train_cli
from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
from scene_3dreconstruction_mvsnet_tpu_torch.models import ConvGRUCell, RMVSNet, find_model_def, random_init_
from scene_3dreconstruction_mvsnet_tpu_torch.models import rmvsnet
from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels
from scene_3dreconstruction_mvsnet_tpu_torch.utils import tracing

torch.set_num_threads(1)

SETTING = {"views": 3, "img_hw": [64, 80], "numdepth": 16, "depth_min": 425.0, "depth_interval": 25.0,
           "interval_scale": 1.0}
TRAFFIC = {"pool": 1, "z0_mm": [600.0, 720.0], "slope": 0.15,
           "ring": {"cameras": 7, "radius_mm": 40.0, "height_mm": 0.0, "target_z_mm": 650.0, "focal_over_width": 1.1}}
SPAN = SETTING["numdepth"] * SETTING["depth_interval"]  # the depth range
SEEDS = (1, 2, 3)
# bf16 against the f32 reference: a pixel whose two best planes' logits lie
# within the bf16 rounding of the cells' inputs may take the other plane, and
# with random weights many do (the softmax is near uniform: the probability
# of the best plane is 0.063-0.087 where 1/16 is 0.0625). The reference
# rounded to bf16 (a witness) moves the mean depth by up to 0.084 x the range
# and the mean probability by up to 7.3e-5 on these seeds, the port by up to
# 0.044 and 7.8e-5; the fp8 control moves them by 0.0076-0.165 and
# 3.9e-4-2.1e-3. So the bf16 tolerance is 0.1 x the range on the mean depth
# and 2.5e-4 on the mean probability, which the control fails by the second.
BF16_DEPTH, BF16_PROB = 0.1, 2.5e-4
# f32: the port sweeps with its own plain path and runs its convs in another
# order; the probability agrees within 2.3e-8 (4 seeds), the depth wherever the
# reference's two best logits differ by more than F32_MARGIN
F32_PROB, F32_MARGIN = 1e-6, 1e-5


def _request(seed):
    req = scenes.request_pool(seed, TRAFFIC, SETTING, "cpu")[0]
    return (torch.as_tensor(req["imgs"]), torch.as_tensor(req["proj_matrices"]), torch.as_tensor(req["depth_values"]))


def _models(seed, dtype=None):
    """The reference and the port with one state dict from ``seed``."""
    ref = ref_rmvs.RMVSNet().eval()
    state = make_state_dict(ref.state_dict(), seed, "cpu")
    ref.load_state_dict(state)
    port = RMVSNet(dtype=dtype).eval()
    port.load_state_dict(state)
    return ref, port


def _errors(got, want):
    """(mean |depth error| / range, mean |probability error|)."""
    return ((got["depth"] - want["depth"]).abs().mean().item() / SPAN,
            (got["photometric_confidence"] - want["photometric_confidence"]).abs().mean().item())


@pytest.fixture(scope="module")
def reference_outputs():
    """Each seed's reference answer and its logits' margin: the gap between
    the best and the second plane's logit [B, h, w]."""
    out = {}
    for seed in SEEDS:
        ref, _ = _models(seed)
        imgs, proj, dv = _request(seed)
        with torch.no_grad():
            want = ref(imgs.float() / 255, proj, dv)
        top2 = want["logits"].topk(2, dim=1).values
        out[seed] = (want, top2[:, 0] - top2[:, 1])
    return out


def test_find_model_def_gives_rmvsnet():
    assert find_model_def("rmvsnet") is RMVSNet


def test_the_gru_cell_follows_its_equations_in_f64():
    torch.manual_seed(0)
    cell = ConvGRUCell(5, 3).double()
    x, h = torch.randn(2, 5, 7, 9, dtype=torch.float64), torch.randn(2, 3, 7, 9, dtype=torch.float64)
    gw, gb = cell.gates.weight, cell.gates.bias
    r = torch.sigmoid(F.conv2d(torch.cat([x, h], 1), gw[:3], gb[:3], padding=1))
    u = torch.sigmoid(F.conv2d(torch.cat([x, h], 1), gw[3:], gb[3:], padding=1))
    c = torch.tanh(F.conv2d(torch.cat([x, r * h], 1), cell.candidate.weight, cell.candidate.bias, padding=1))
    want = (1 - u) * h + u * c
    with torch.no_grad():
        got = cell(x, h)
        ref = ref_rmvs.ConvGRUCell(5, 3).double()
        ref.load_state_dict(cell.state_dict(), strict=True)
        assert torch.allclose(ref(x, h), want, rtol=0, atol=1e-12)
    assert got.dtype == torch.float64 and torch.allclose(got, want, rtol=0, atol=1e-12)
    assert cell.gates.weight.shape == (6, 8, 3, 3) and cell.candidate.weight.shape == (3, 8, 3, 3)


@pytest.mark.parametrize("chunk", [4, 6])
@pytest.mark.parametrize("seed", SEEDS)
def test_rmvsnet_matches_the_reference_in_f32(monkeypatch, reference_outputs, seed, chunk):
    """The probability within F32_PROB; the depth equal wherever the
    reference's two best logits differ by more than F32_MARGIN (the only
    pixels where another order of the same f32 arithmetic may pick the other
    plane); K1's chunks of 6 leave a remainder of 4 planes."""
    monkeypatch.setattr(rmvsnet, "PLANE_CHUNK", chunk)
    want, margin = reference_outputs[seed]
    _, port = _models(seed)
    imgs, proj, dv = _request(seed)
    with torch.no_grad():
        got = port(imgs.float() / 255, proj, dv)
    assert got["depth"].shape == got["photometric_confidence"].shape == (1, 16, 20)
    assert (got["photometric_confidence"] - want["photometric_confidence"]).abs().max().item() <= F32_PROB
    clear = margin > F32_MARGIN
    assert clear.float().mean() > 0.95 and torch.equal(got["depth"][clear], want["depth"][clear])


def test_the_maps_are_not_degenerate(reference_outputs):
    """With random weights the winner-take-all depth varies over the image,
    and its probability lies above the uniform 1/D."""
    for want, _ in reference_outputs.values():
        assert want["depth"].unique().numel() >= 4
        assert (want["photometric_confidence"] > 1 / 16).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_rmvsnet_in_bf16_is_within_the_bf16_tolerance(monkeypatch, reference_outputs, seed):
    monkeypatch.setattr(rmvsnet, "PLANE_CHUNK", 6)
    want, _ = reference_outputs[seed]
    _, port = _models(seed, torch.bfloat16)
    imgs, proj, dv = _request(seed)
    with torch.no_grad():
        depth_err, prob_err = _errors(port(imgs.float() / 255, proj, dv), want)
    assert depth_err <= BF16_DEPTH and prob_err <= BF16_PROB


@pytest.mark.parametrize("seed", SEEDS)
def test_the_bf16_tolerance_fails_the_reference_one_precision_down(reference_outputs, seed):
    want, _ = reference_outputs[seed]
    ref, _ = _models(seed)
    imgs, proj, dv = _request(seed)
    with torch.no_grad():
        depth_err, prob_err = _errors(ref(imgs.float() / 255, proj, dv, rounding("fp8")), want)
    assert depth_err > BF16_DEPTH or prob_err > BF16_PROB


@pytest.mark.parametrize("fault", ref_rmvs.FAULTS)
def test_every_fault_changes_the_answer_beyond_the_f32_tolerance(reference_outputs, fault):
    for seed in SEEDS:
        want, margin = reference_outputs[seed]
        ref, _ = _models(seed)
        imgs, proj, dv = _request(seed)
        with torch.no_grad():
            got = ref(imgs.float() / 255, proj, dv, fault=fault)
        clear = margin > F32_MARGIN
        moved = (got["photometric_confidence"] - want["photometric_confidence"]).abs().max().item() > F32_PROB
        assert moved or not torch.equal(got["depth"][clear], want["depth"][clear]), (fault, seed)
    with pytest.raises(ValueError, match="unknown fault"):
        ref(imgs.float() / 255, proj, dv, fault="no_such_fault")


def test_winner_take_all_takes_the_first_of_equal_planes():
    logits = torch.tensor([0.5, 2.0, -1.0, 2.0, 1.0])[None, :, None, None].repeat(2, 1, 3, 4)
    logits[1, :, 1, 2] = torch.tensor([3.0, 3.0, 3.0, 3.0, 3.0])
    logits[1, 4, 0, 0] = 7.0
    dv = torch.linspace(500.0, 900.0, 5)[None].repeat(2, 1)
    dv[1] += 1.0
    depth, prob = rmvsnet.winner_take_all(logits, dv)
    want_depth, want_prob = ref_rmvs.winner_take_all(logits, dv)
    assert torch.equal(depth, want_depth) and torch.allclose(prob, want_prob, rtol=1e-6, atol=0)
    assert depth[0, 0, 0] == 600.0 and depth[1, 1, 2] == 501.0 and depth[1, 0, 0] == 901.0
    assert prob[0, 0, 0].item() == pytest.approx(torch.softmax(logits[0, :, 0, 0], 0)[1].item(), rel=1e-6)
    assert prob[1, 1, 2].item() == pytest.approx(0.2, rel=1e-6)


def test_one_state_dict_loads_into_the_port_and_the_reference():
    ref, port = ref_rmvs.RMVSNet(), RMVSNet()
    assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == \
           {k: tuple(v.shape) for k, v in port.state_dict().items()}
    state = random_init_(port, torch.Generator().manual_seed(1)).state_dict()
    assert state["cost_conv.weight"].shape == (16, 32, 3, 3) and state["prob.weight"].shape == (1, 2, 3, 3)
    assert state["gru.0.gates.weight"].shape == (32, 32, 3, 3) and state["gru.2.candidate.weight"].shape == (2, 6, 3, 3)
    assert "feature.conv0.conv.weight" in state and "feature.feature.bias" in state
    ref.load_state_dict(state, strict=True)
    RMVSNet().load_state_dict(ref.state_dict(), strict=True)


def test_training_rmvsnet_raises():
    port = RMVSNet().train()
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 4 item 4"):
        port(*(t.float() for t in _request(1)))


@pytest.mark.parametrize("cli,model,path", [
    (eval_cli, "rmvsnet", "eval"), (eval_cli, "casmvsnet", "eval"), (evaldtu_cli, "rmvsnet", "eval"),
    (evaldtu_cli, "casmvsnet", "eval"), (train_cli, "rmvsnet", "training"),
])
def test_a_cli_refuses_a_model_without_its_path(cli, model, path):
    """``--model`` goes through the registry: a model without the CLI's path
    is refused with the ROADMAP.md item that plans it, before any data is
    read."""
    with pytest.raises(NotImplementedError, match=f"--model {model} has no {path} path yet \\(ROADMAP.md, Queue 4"):
        cli.main(["--model", model, "--device", "cpu"])


@pytest.mark.parametrize("chunk,sweeps", [(4, 4), (6, 3)])
def test_the_serving_entry_records_the_rmvsnet_spans(monkeypatch, chunk, sweeps):
    monkeypatch.setattr(rmvsnet, "PLANE_CHUNK", chunk)
    _, port = _models(6)
    tracing.enable()
    try:
        out = make_infer_step(port, "cpu")(*_request(6))
        spans = tracing.take()["spans"]
    finally:
        tracing.disable()
    assert set(out) == {"depth", "photometric_confidence"}
    names = [s["name"] for s in spans]
    assert names == ["infer", "infer.h2d", "rmvsnet.features", "rmvsnet.recurrence", *["rmvsnet.sweep"] * sweeps,
                     "rmvsnet.regress"]
    recurrence = names.index("rmvsnet.recurrence")
    assert all(s["parent"] == recurrence for s in spans if s["name"] == "rmvsnet.sweep")


@pytest.mark.parametrize("chunk", [4, 6])
def test_k1_launches_once_a_chunk_under_sweep_variance(monkeypatch, chunk):
    """Each chunk of planes is one K1 call with that chunk's planes, counted
    under ``sweep_variance`` through the registry (the launch faked on the
    CPU before the plain sweep runs)."""
    # imported here: where another top-level `tests` is installed, the file still collects its cuda tests
    from tests.test_torch_launch_counts import install_fakes

    fakes = install_fakes(monkeypatch)
    plain, planes = rmvsnet.sweep_variance, []

    def counted(feats, proj, depth_values, **kwargs):
        planes.append(depth_values.shape[1])
        kernels.launch(fakes.entry(), device=torch.device("cuda:0"), name="sweep_variance")
        return plain(feats, proj, depth_values, **kwargs)

    monkeypatch.setattr(rmvsnet, "sweep_variance", counted)
    monkeypatch.setattr(rmvsnet, "PLANE_CHUNK", chunk)
    _, port = _models(7)
    with torch.no_grad():
        port(*(t.float() for t in _request(7)))
    assert planes == [chunk] * (16 // chunk) + ([16 % chunk] if 16 % chunk else [])
    assert {k: n for k, n in kernels.launch_counts().items() if n} == {"sweep_variance": math.ceil(16 / chunk)}
    kernels.reset_launch_counts()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_rmvsnet_on_the_card_matches_the_reference_without_a_host_sync(cuda, monkeypatch, reference_outputs, dtype):
    """The forward on the card (TF32 off), after the first has captured the
    plane step's graph, under the sync debug mode 'error': no host sync; one
    K1 launch a chunk of 6 (a remainder of 4); in f32 the CPU tests' f32
    tolerances, in bf16 their bf16 tolerance."""
    monkeypatch.setattr(rmvsnet, "PLANE_CHUNK", 6)
    seed = SEEDS[0]
    want, margin = reference_outputs[seed]
    _, port = _models(seed, dtype)
    port = port.to(cuda)
    args = [t.to(cuda) for t in _request(seed)]
    args[0] = args[0].float() / 255
    with torch.no_grad():
        port(*args)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            got = port(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert {k: n for k, n in kernels.launch_counts().items() if n} == {"sweep_variance": 3}
    got = {k: v.cpu() for k, v in got.items()}
    if dtype is None:
        clear = margin > F32_MARGIN
        assert (got["photometric_confidence"] - want["photometric_confidence"]).abs().max().item() <= 1e-5
        assert torch.equal(got["depth"][clear], want["depth"][clear])
    else:
        depth_err, prob_err = _errors(got, want)
        assert depth_err <= BF16_DEPTH and prob_err <= BF16_PROB


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_the_graph_replay_gives_the_eager_steps_bits(cuda, monkeypatch, dtype):
    """The plane step replayed from its CUDA graph against the same step
    called eagerly on the card; the graph is captured once and reused, and
    weights loaded into the same parameters are the ones it replays."""
    monkeypatch.setattr(rmvsnet, "PLANE_CHUNK", 6)
    args = [t.to(cuda) for t in _request(2)]
    args[0] = args[0].float() / 255
    _, port = _models(2, dtype)
    port = port.to(cuda)
    with torch.no_grad():
        got = port(*args)
        graph = next(iter(port._graphs.values()))
        again = port(*args)
        assert list(port._graphs.values()) == [graph]
        port.load_state_dict(_models(3)[1].state_dict())
        other = port(*args)
        assert list(port._graphs.values()) == [graph]
        monkeypatch.setattr(rmvsnet.RMVSNet, "_plane_step",
                            lambda self, B, h, w, dt, device: rmvsnet._EagerStep(self, B, h, w, device))
        eager_other = port(*args)
        port.load_state_dict(_models(2)[1].state_dict())
        eager = port(*args)
    for a, b in ((got, eager), (again, eager), (other, eager_other)):
        assert torch.equal(a["depth"], b["depth"]) and torch.equal(a["photometric_confidence"],
                                                                  b["photometric_confidence"])
    assert not torch.equal(got["photometric_confidence"], other["photometric_confidence"])


@pytest.mark.cuda
def test_the_serving_entry_serves_the_dtu_test_setting_on_the_card(cuda):
    """``make_infer_step(RMVSNet(torch.bfloat16), 'cuda')`` on 5 views at
    1200x1600 and 256 planes of 2 mm from 425 mm: [1, 300, 400] maps, depths
    on the planes, probabilities in (1/256, 1], one K1 launch a chunk."""
    setting = dict(SETTING, views=5, img_hw=[1200, 1600], numdepth=256, depth_interval=2.5, interval_scale=0.8)
    traffic = dict(TRAFFIC, ring=dict(TRAFFIC["ring"], cameras=49, radius_mm=150.0))
    req = scenes.request_pool(11, traffic, setting, cuda)[0]
    model = random_init_(RMVSNet(torch.bfloat16), torch.Generator().manual_seed(11))
    infer = make_infer_step(model, cuda)
    kernels.reset_launch_counts()
    out = infer(*(torch.as_tensor(req[k]) for k in ("imgs", "proj_matrices", "depth_values")))
    torch.cuda.synchronize()
    depth, prob = out["depth"].cpu(), out["photometric_confidence"].cpu()
    assert depth.shape == prob.shape == (1, 300, 400)
    planes = torch.as_tensor(req["depth_values"])[0]
    assert torch.isin(depth, planes).all() and depth.unique().numel() > 1
    assert ((prob > 1 / 256) & (prob <= 1.0)).all()
    assert kernels.launch_counts()["sweep_variance"] == math.ceil(256 / rmvsnet.PLANE_CHUNK)
