"""The port's sweep axis on the CPU: the cost volume's depth planes split over
the ranks of a sweep group (``parallel/halo.py``, ``parallel/mesh.py::
make_mesh``, ``parallel/sharding.py::volume_sharding``), held to the unsplit
modules of one process in f64 and to the JAX package's unsharded model in
f32.

Four gloo ranks (``python -c`` processes on a free localhost port) run one
job, with a timeout: they lay themselves out as a data=2 x sweep=2 mesh
(sweep groups of 2, the JAX package's tests/test_parallel.py mesh) and as a
data=1 x sweep=4 mesh, and each rank writes what the tests below check. The
shapes are tiny (3 views, 32x32 images, D=32), so that S=4 leaves 8 planes
a rank and the coarsest CostRegNet level one."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.autograd import gradcheck

from scene_3dreconstruction_mvsnet_tpu import models as jmodels
from scene_3dreconstruction_mvsnet_tpu.interop import export_torch_state_dict
from scene_3dreconstruction_mvsnet_tpu.parallel import make_mesh as j_make_mesh
from scene_3dreconstruction_mvsnet_tpu.train import TrainState
from scene_3dreconstruction_mvsnet_tpu.train import make_train_step as j_make_train_step
from scene_3dreconstruction_mvsnet_tpu_torch.interop import load_jax_variables
from scene_3dreconstruction_mvsnet_tpu_torch.interop.from_jax import _put_deconv_bn
from scene_3dreconstruction_mvsnet_tpu_torch.models import ConvTransposeBnReLU3D, CostRegNet, MVSNet, random_init_
from scene_3dreconstruction_mvsnet_tpu_torch.parallel import VolumeSharding, exchange_halos, gather_depth
from scene_3dreconstruction_mvsnet_tpu_torch.train import make_scheduler, make_train_step
from tests.test_parallel import _tiny_batch
from tests.test_torch_api import _randomize

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
RANK_TIMEOUT_S = 300  # the whole job: ~40 s on one core each
LR = 1e-3
D = 32
HALO_LAYOUTS = ((1, 1), (1, 0), (0, 1))  # (lower, upper) planes: stride-1, stride-2 and transposed convs

# one rank of the job: reads its task from argv[1], writes its results to argv[2]
_RANK = r"""
import sys
import torch
import torch.distributed as dist
from torch.autograd import gradcheck
torch.set_num_threads(1)
from scene_3dreconstruction_mvsnet_tpu_torch.models import CostRegNet, MVSNet
from scene_3dreconstruction_mvsnet_tpu_torch.models.blocks import _FlaxRunningVar
from scene_3dreconstruction_mvsnet_tpu_torch.parallel import (
    all_reduce_grads, exchange_halos, gather_depth, initialize_multihost, make_global_mesh, make_mesh,
    make_sharded_train_step, volume_sharding,
)
from scene_3dreconstruction_mvsnet_tpu_torch.train import make_scheduler

task = torch.load(sys.argv[1], weights_only=False)
rank = int(sys.argv[3])
initialize_multihost(f"127.0.0.1:{task['port']}", task["world"], rank, backend="gloo", timeout_s=120)
meshes = {2: make_mesh(2, 2), 4: make_mesh(1, 4)}  # keyed by the sweep group's size
out = {"coords": {S: (m.data_index, m.sweep_index, m.data, m.sweep) for S, m in meshes.items()}}
g2, auto = make_global_mesh(sweep=2), make_global_mesh(sweep=0)
out["global"] = [(g2.data_index, g2.sweep_index, g2.data, g2.sweep), (auto.data, auto.sweep)]
try:
    make_global_mesh(sweep=3)
except ValueError as e:
    out["global_refused"] = str(e)


class SumGradOver(torch.autograd.Function):
    # the identity, whose backward sums the gradient over the group: every
    # rank takes its slice of the same global input
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


# 1. the halo exchange and the gather: f(global x) on every rank, held by gradcheck
out["halo"], out["gather"] = {}, {}
for S, mesh in meshes.items():
    grp, s = mesh.sweep_group, mesh.sweep_index
    x = task["halo_x"].clone().requires_grad_()
    L = x.shape[2] // S
    mine = lambda t: SumGradOver.apply(t, grp)[:, :, s * L:(s + 1) * L]
    for lo, up in task["layouts"]:
        fn = lambda t: gather_depth(exchange_halos(mine(t), 2, lo, up, grp), 2, grp)
        out["halo"][(S, lo, up)] = (fn(x).detach(), gradcheck(fn, (x,), raise_exception=False))
    fn = lambda t: gather_depth(mine(t), 2, grp)
    out["gather"][S] = (fn(x).detach(), gradcheck(fn, (x,), raise_exception=False))

# 2. CostRegNet on this rank's planes, eval and train; bf16 eval through K4's plain version
out["crn"], out["crn_fused"] = {}, {}
for S, mesh in meshes.items():
    vs = volume_sharding(mesh)
    sl = vs.depth_slice(task["crn_x"].shape[1])
    for mode in ("eval", "train"):
        net = CostRegNet().double()
        net.load_state_dict(task["crn_state"])
        net.train(mode == "train")
        for m in net.modules():
            if isinstance(m, _FlaxRunningVar):
                m.process_group = mesh.sweep_group
        x = task["crn_x"][:, sl].clone().requires_grad_()
        y = net(x, vs)
        y.backward(task["crn_g"][:, sl])
        all_reduce_grads(net.parameters(), mesh.sweep_group)
        out["crn"][(S, mode)] = {"y": y.detach(), "dx": x.grad, "grads": {n: p.grad for n, p in net.named_parameters()},
                                 "buffers": dict(net.named_buffers())}
    net = CostRegNet(fused_conv0=True)
    net.load_state_dict(task["crn_state"])
    with torch.no_grad():
        out["crn_fused"][S] = net.eval()(task["crn_x"][:, sl].bfloat16(), vs)

# 3. the MVSNet eval forward at sweep=2, f64 and f32
mesh = meshes[2]
vs = volume_sharding(mesh)
b = task["batch"]
for tag, dtype, state in (("f64", torch.float64, task["state64"]), ("f32", torch.float32, task["state32"])):
    model = MVSNet(dtype=dtype if dtype == torch.float64 else None, volume_sharding=vs).to(dtype)
    model.load_state_dict(state)
    with torch.no_grad():
        out["fwd_" + tag] = model.eval()(*(torch.from_numpy(b[k]).to(dtype) for k in ("imgs", "proj_matrices",
                                                                                      "depth_values")))

# 4. the data x sweep SGD step (and with remat: the recompute runs the halo
# exchanges and the BatchNorm reductions again inside the backward)
for tag, refine, remat, dtype, state in (("f64", False, False, torch.float64, task["state64"]),
                                         ("f64_refine", True, False, torch.float64, task["state64_refine"]),
                                         ("f64_remat", False, True, torch.float64, task["state64"]),
                                         ("f32", False, False, torch.float32, task["state32"])):
    model = MVSNet(refine=refine, dtype=dtype if dtype == torch.float64 else None, remat=remat,
                   volume_sharding=vs).to(dtype)
    if rank == 0:  # the other ranks start from rank 0's weights through the broadcast
        model.load_state_dict(state)
    opt = torch.optim.SGD(model.parameters(), lr=task["lr"])
    step, shard_fn = make_sharded_train_step(model, opt, make_scheduler(opt, "10:2", 100), "cpu", mesh=mesh)
    aux = step(shard_fn({k: torch.from_numpy(v).to(dtype) for k, v in b.items()}))
    out["step_" + tag] = {"loss": aux["loss"], "metrics": {k: v for k, v in aux.items() if "error" in k},
                          "grads": {n: p.grad for n, p in model.named_parameters()}, "state": model.state_dict()}
refused = []
for kw in ({"mesh": mesh}, {"mesh": mesh, "group": mesh.world}):
    model = MVSNet(volume_sharding=None if "group" not in kw else vs)
    opt = torch.optim.SGD(model.parameters(), lr=task["lr"])
    try:
        make_sharded_train_step(model, opt, make_scheduler(opt, "10:2", 100), "cpu", **kw)
    except ValueError as e:
        refused.append(str(e))
out["refused"] = refused

# 5. the transposed conv without its ReLU on this rank's half of D (sweep=2), eval and train
from scene_3dreconstruction_mvsnet_tpu_torch.models import ConvTransposeBnReLU3D
mesh = meshes[2]
vs = volume_sharding(mesh)
L = task["deconv_x"].shape[2] // 2
out["deconv"] = {}
for mode in ("eval", "train"):
    blk = ConvTransposeBnReLU3D(*task["deconv_channels"], relu=False).double()
    blk.load_state_dict(task["deconv_state"])
    blk.train(mode == "train")
    blk[1].process_group = mesh.sweep_group
    with torch.no_grad():
        y = blk(task["deconv_x"][:, :, mesh.sweep_index * L:(mesh.sweep_index + 1) * L], vs)
    out["deconv"][mode] = {"y": y, "buffers": dict(blk.named_buffers())}
torch.save(out, sys.argv[2])
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mvsnet_state(dtype, refine=False, seed=1) -> dict:
    model = MVSNet(refine=refine, dtype=dtype if dtype == torch.float64 else None).to(dtype)
    return random_init_(model, torch.Generator().manual_seed(seed)).state_dict()


def _batch() -> dict:
    """tests/test_parallel.py's batch (3 views, 32x32 images) at B=4 and D
    planes; the first data rank's rows keep a quarter of the second's valid
    pixels, so the loss's shares must be weighed by the global count."""
    batch = _tiny_batch(np.random.RandomState(0), B=4, D=D)
    batch["mask"][:2, :, 2:] = 0.0
    return batch


@pytest.fixture(scope="module")
def jax_model():
    """The JAX MVSNet and its variables, initialised on the batch."""
    batch = _batch()
    jmodel = jmodels.MVSNet()
    jvars = jax.device_get(jmodel.init(jax.random.PRNGKey(0), batch["imgs"], batch["proj_matrices"],
                                       batch["depth_values"]))
    return jmodel, jvars


DECONV_CHANNELS = (8, 4)  # in, out


def _deconv_x() -> np.ndarray:
    """The transposed conv's input, NCDHW [2, 8, 8, 4, 4] (D = 8: 4 planes a
    rank at sweep=2)."""
    return np.random.RandomState(11).randn(2, DECONV_CHANNELS[0], 8, 4, 4).astype(np.float32)


def _deconv_jax():
    """The JAX ConvTransposeBnReLU3D(relu=False) and its variables, every
    leaf drawn from a seed (BatchNorm scales and variances near 1)."""
    block = jmodels.ConvTransposeBnReLU3D(DECONV_CHANNELS[1], relu=False)
    x = jnp.asarray(np.moveaxis(_deconv_x(), 1, -1))
    return block, _randomize(block.init(jax.random.PRNGKey(0), x), 12)


def _deconv_state(variables) -> dict:
    """The JAX block's variables as the port's state dict, in f64."""
    state: dict = {}
    _put_deconv_bn(state, "b", variables["params"], variables["batch_stats"])
    state = {k.removeprefix("b."): torch.from_numpy(np.array(v, np.float64)) for k, v in state.items()}
    state["1.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return state


@pytest.fixture(scope="module")
def job(tmp_path_factory, jax_model):
    """Run the rank job once; (task, the ranks' results in rank order)."""
    tmp = tmp_path_factory.mktemp("sweep_job")
    gen = torch.Generator().manual_seed(0)
    crn = random_init_(CostRegNet().double(), gen)
    task = {
        "port": _free_port(), "world": WORLD, "lr": LR, "layouts": HALO_LAYOUTS,
        "halo_x": torch.randn(1, 2, 8, 3, 2, generator=gen, dtype=torch.float64),
        "crn_state": crn.state_dict(),
        "crn_x": torch.randn(2, D, 8, 8, 32, generator=gen, dtype=torch.float64),
        "crn_g": torch.randn(2, D, 8, 8, 1, generator=gen, dtype=torch.float64),
        "batch": {k: v.astype(np.float64) for k, v in _batch().items()},
        "state64": _mvsnet_state(torch.float64),
        "state64_refine": _mvsnet_state(torch.float64, refine=True),
        "state32": load_jax_variables(MVSNet(), jax_model[1]).state_dict(),
        "deconv_channels": DECONV_CHANNELS,
        "deconv_x": torch.from_numpy(_deconv_x()).double(),
        "deconv_state": _deconv_state(_deconv_jax()[1]),
    }
    spec = tmp / "task.pt"
    torch.save(task, spec)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(spec), str(tmp / f"out{r}.pt"), str(r)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return task, [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(WORLD)]


def _close(got: torch.Tensor, want: torch.Tensor, rel: float, what: str) -> None:
    """max|got - want| within ``rel`` x max|want|."""
    got, want = got.double(), want.double()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} > {rel:.0e} x {scale:.3e}"


def test_make_mesh_order_matches_jax(job):
    """Rank r sits where the JAX make_mesh puts device r (its
    ``devices.reshape(data, sweep)``), for data=2 x sweep=2 and 1 x 4;
    make_global_mesh factors the world as the JAX one does and refuses a
    sweep that does not divide it."""
    _, ranks = job
    devices = jax.devices()[:WORLD]
    for S, (data, sweep) in {2: (2, 2), 4: (1, 4)}.items():
        grid = j_make_mesh(data=data, sweep=sweep, devices=devices).devices
        for r, out in enumerate(ranks):
            where = tuple(int(i) for i in np.argwhere(grid == devices[r])[0])
            assert out["coords"][S] == (*where, data, sweep), (S, r)
    for r, out in enumerate(ranks):
        assert out["global"] == [(r // 2, r % 2, 2, 2), (1, 4)]
        assert out["global_refused"] == "4 global ranks not divisible by sweep=3"


def test_depth_slice_and_remat_refusals():
    """A sweep rank's planes, and the splits refused: D not a multiple of 8
    x the sweep ranks (CostRegNet's three stride-2 levels). remat is no
    longer refused with a split: the model builds with both."""
    assert VolumeSharding(None, 2, 1).depth_slice(32) == slice(16, 32)
    assert VolumeSharding(None, 4, 2).depth_slice(64) == slice(32, 48)
    for size, planes in ((2, 24), (4, 16), (1, 12)):
        with pytest.raises(ValueError, match=f"multiple of {8 * size}"):
            VolumeSharding(None, size, 0).depth_slice(planes)
    model = MVSNet(remat=True, volume_sharding=VolumeSharding(None, 2, 0))
    assert model.remat and model.volume_sharding.size == 2


def test_one_rank_halos_are_zero_padding():
    """With no group (or one rank) the halos are the unsplit conv's zero
    padding and the gather is the identity, forward and backward."""
    x = torch.randn(1, 2, 5, 3, 2, dtype=torch.float64, requires_grad=True)
    for lo, up in HALO_LAYOUTS:
        torch.testing.assert_close(exchange_halos(x, 2, lo, up, None), F.pad(x, (0, 0, 0, 0, lo, up)), rtol=0, atol=0)
        assert gradcheck(lambda t: exchange_halos(t, 2, lo, up, None), (x,))  # noqa: B023
    assert gather_depth(x, 2, None) is x
    with pytest.raises(ValueError, match="halos"):
        exchange_halos(x[:, :, :1], 2, 2, 1, None)


def test_one_rank_split_equals_unsplit():
    """MVSNet with a one-rank split (its halos zeros, its gather the identity)
    against MVSNet without: the eval forward and a train step in f64, equal
    to rounding (1e-12 x the largest value)."""
    batch = {k: torch.from_numpy(v.astype(np.float64)) for k, v in _batch().items()}
    state = _mvsnet_state(torch.float64)
    runs = []
    for split in (None, VolumeSharding(None, 1, 0)):
        model = MVSNet(dtype=torch.float64, volume_sharding=split).double()
        model.load_state_dict(state)
        with torch.no_grad():
            fwd = model.eval()(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        aux = make_train_step(model, opt, make_scheduler(opt, "10:2", 100), "cpu")(batch)
        runs.append((fwd, aux, {n: p.grad for n, p in model.named_parameters()}))
    (f0, a0, g0), (f1, a1, g1) = runs
    for k in f0:
        _close(f1[k], f0[k], 1e-12, k)
    _close(a1["loss"], a0["loss"], 1e-12, "loss")
    for n in g0:
        _close(g1[n], g0[n], 1e-12, n)


@pytest.mark.parametrize("S", [2, 4])
def test_halo_exchange_and_gather_over_ranks(job, S):
    """exchange_halos over S gloo ranks (D=8 planes, 8/S a rank): each rank's
    slice with its neighbours' planes attached and zeros at the volume's
    ends, for the three (lower, upper) layouts the convs use; gather_depth
    gives back the whole axis. Both through gradcheck in f64, on a function
    of the global input that every rank computes (each rank's part of the
    input's gradient summed over the ranks)."""
    task, ranks = job
    x = task["halo_x"]
    L = x.shape[2] // S
    zero = torch.zeros_like(x[:, :, :1])
    for lo, up in HALO_LAYOUTS:
        parts = []
        for s in range(S):
            below = x[:, :, s * L - lo : s * L] if s > 0 else zero[:, :, :lo]
            above = x[:, :, (s + 1) * L : (s + 1) * L + up] if s < S - 1 else zero[:, :, :up]
            parts.append(torch.cat([below, x[:, :, s * L : (s + 1) * L], above], 2))
        want = torch.cat(parts, 2)
        for r in range(WORLD):
            got, ok = ranks[r]["halo"][(S, lo, up)]
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            assert ok, f"gradcheck of exchange_halos (lower {lo}, upper {up}) failed on rank {r}"
    for r in range(WORLD):
        got, ok = ranks[r]["gather"][S]
        torch.testing.assert_close(got, x, rtol=0, atol=0)
        assert ok, f"gradcheck of gather_depth failed on rank {r}"


@pytest.mark.parametrize("S,mode", [(2, "eval"), (2, "train"), (4, "eval"), (4, "train")])
def test_cost_reg_net_split_matches_unsplit(job, S, mode):
    """CostRegNet on each sweep rank's D/S planes (halo-padded convs, the
    train-mode BatchNorm reduced over the sweep group) against the unsplit
    module in f64: the output, the input gradient and the parameter
    gradients (summed over the ranks) for one cotangent, and the BatchNorm
    buffers, within 1e-10 x each tensor's largest magnitude."""
    task, ranks = job
    net = CostRegNet().double()
    net.load_state_dict(task["crn_state"])
    net.train(mode == "train")
    x = task["crn_x"].clone().requires_grad_()
    y = net(x)
    y.backward(task["crn_g"])
    L = D // S
    for r, out in enumerate(ranks):
        got = out["crn"][(S, mode)]
        s = out["coords"][S][1]
        _close(got["y"], y.detach()[:, s * L : (s + 1) * L], 1e-10, f"rank {r} output")
        _close(got["dx"], x.grad[:, s * L : (s + 1) * L], 1e-10, f"rank {r} input gradient")
        for n, p in net.named_parameters():
            _close(got["grads"][n], p.grad, 1e-10, f"rank {r} {n}")
        for n, b in net.named_buffers():
            _close(got["buffers"][n], b, 1e-10, f"rank {r} {n}")


@pytest.mark.parametrize("S", [2, 4])
def test_cost_reg_net_fused_conv0_split_matches_unsplit(job, S):
    """The bf16 eval CostRegNet with the fused conv0 (K4's plain version on
    the CPU, run on the slice extended by one plane each side, its edge
    planes dropped) on each sweep rank's planes against the unsplit bf16
    forward: within 2e-2 x the output's largest magnitude, the distance a
    few bf16 roundings that differ with the convs' shapes can reach (a
    wrong or missing halo plane is off by the output's own size)."""
    task, ranks = job
    net = CostRegNet(fused_conv0=True)
    net.load_state_dict(task["crn_state"])
    with torch.no_grad():
        want = net.eval()(task["crn_x"].bfloat16())
    L = D // S
    for r, out in enumerate(ranks):
        s = out["coords"][S][1]
        _close(out["crn_fused"][S], want[:, s * L : (s + 1) * L], 2e-2, f"rank {r}")


def test_mvsnet_eval_split_matches_one_process_and_jax(job, jax_model):
    """The MVSNet eval forward with its planes split over sweep=2 against the
    port's one-process forward in f64 (1e-10 x the largest value, on every
    rank), and in f32 against the JAX package's unsharded forward from the
    same variables (depth within 1e-3 x the depth range, confidence atol
    1e-4, the bounds tests/test_models_parity.py uses)."""
    task, ranks = job
    b = task["batch"]
    args = [torch.from_numpy(b[k]) for k in ("imgs", "proj_matrices", "depth_values")]
    model = MVSNet(dtype=torch.float64).double()
    model.load_state_dict(task["state64"])
    with torch.no_grad():
        want = model.eval()(*args)
    jmodel, jvars = jax_model
    jout = jmodel.apply(jvars, *(jnp.asarray(b[k], jnp.float32) for k in ("imgs", "proj_matrices", "depth_values")),
                        train=False)
    depth_range = float(np.ptp(b["depth_values"]))
    for r, out in enumerate(ranks):
        for k in want:
            _close(out["fwd_f64"][k], want[k], 1e-10, f"rank {r} {k}")
        depth_err = np.abs(out["fwd_f32"]["depth"].numpy() - np.asarray(jout["depth"])).max()
        assert depth_err < 1e-3 * depth_range, (r, depth_err)
        np.testing.assert_allclose(out["fwd_f32"]["photometric_confidence"].numpy(),
                                   np.asarray(jout["photometric_confidence"]), atol=1e-4, err_msg=f"rank {r}")


@pytest.mark.parametrize("refine", [False, True], ids=["plain", "refine"])
def test_data_sweep_step_matches_one_process(job, refine):
    """One SGD step on the data=2 x sweep=2 mesh against the one-process step
    on the whole batch of 4, f64: the loss at rtol 1e-10, the metrics at
    rtol 1e-10, the BatchNorm buffers at rtol 1e-10; CostRegNet's and
    RefineNet's gradients within 1e-8 x each tensor's largest magnitude;
    parameters and buffers equal on all four ranks. FeatureNet's gradient
    comes through the sweep's backward, whose terms are f32 on every path
    (K3-terms and K3 and their plain versions), so cutting the sums over
    the planes in two moves it by f32 rounding (2.2e-7 of a tensor's
    largest measured here): it is held within 1e-6. With ``refine`` the
    loss is on RefineNet's output, computed whole on every rank of a sweep
    group."""
    task, ranks = job
    tag = "f64_refine" if refine else "f64"
    model = MVSNet(refine=refine, dtype=torch.float64).double()
    model.load_state_dict(task["state64_refine" if refine else "state64"])
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    aux = make_train_step(model, opt, make_scheduler(opt, "10:2", 100), "cpu")(task["batch"])
    for r, out in enumerate(ranks):
        got = out["step_" + tag]
        np.testing.assert_allclose(float(got["loss"]), float(aux["loss"]), rtol=1e-10, err_msg=f"rank {r}")
        for k, v in got["metrics"].items():
            np.testing.assert_allclose(float(v), float(aux[k]), rtol=1e-10, atol=1e-14, err_msg=k)
        for n, p in model.named_parameters():
            _close(got["grads"][n], p.grad, 1e-6 if n.startswith("feature.") else 1e-8, f"rank {r} {n}")
        for n, b in model.named_buffers():
            np.testing.assert_allclose(got["state"][n].numpy(), b.numpy(), rtol=1e-10, err_msg=f"rank {r} {n}")
        for n, t in got["state"].items():
            assert torch.equal(t, ranks[0]["step_" + tag]["state"][n]), (r, n)


def test_data_sweep_remat_step_matches_plain_split_step(job):
    """MVSNet(remat=True, volume_sharding=...) on the data=2 x sweep=2 mesh
    against the plain split step of the same rank, f64, one SGD step from the
    same weights: every gradient within 1e-10 x the largest |g| of the plain
    step, the loss at rtol 1e-10, and each BatchNorm's running statistics
    updated once (the buffers those of the plain step at rtol 1e-10, every
    num_batches_tracked 1), so the recompute's BatchNorm reductions updated
    nothing."""
    _, ranks = job
    for r, out in enumerate(ranks):
        plain, remat = out["step_f64"], out["step_f64_remat"]
        np.testing.assert_allclose(float(remat["loss"]), float(plain["loss"]), rtol=1e-10, err_msg=f"rank {r}")
        largest = max(g.abs().max().item() for g in plain["grads"].values())
        for n, g in plain["grads"].items():
            err = (remat["grads"][n] - g).abs().max().item()
            assert err <= 1e-10 * largest, f"rank {r} {n}: max|err| {err:.3e} > 1e-10 x {largest:.3e}"
        for n, b in plain["state"].items():
            if "running" in n:
                np.testing.assert_allclose(remat["state"][n].numpy(), b.numpy(), rtol=1e-10, err_msg=f"rank {r} {n}")
            elif n.endswith("num_batches_tracked"):
                assert int(remat["state"][n]) == int(b) == 1, (r, n)


def test_data_sweep_step_f32_matches_jax(job, jax_model):
    """The f32 data=2 x sweep=2 SGD step from the JAX package's variables
    against the JAX package's unsharded step (optax.sgd, the same batch): the
    loss at rtol 1e-4, and every parameter after the step within atol 1e-4,
    the bounds tests/test_parallel.py holds the JAX sharded step to. (The
    JAX sharded step compiles for minutes; its own slow test holds it to the
    unsharded one.)"""
    import optax

    task, ranks = job
    jmodel, jvars = jax_model
    state = TrainState.create(jvars, optax.sgd(LR))
    batch = {k: jnp.asarray(v, jnp.float32) for k, v in task["batch"].items()}
    new_state, jaux = jax.device_get(j_make_train_step(jmodel)(state, batch))
    want = export_torch_state_dict(new_state.variables)
    for r, out in enumerate(ranks):
        got = out["step_f32"]
        np.testing.assert_allclose(float(got["loss"]), float(jaux["loss"]), rtol=1e-4, err_msg=f"rank {r}")
        for n, _ in MVSNet().named_parameters():
            np.testing.assert_allclose(got["state"][n].numpy(), want["module." + n], rtol=0, atol=1e-4,
                                       err_msg=f"rank {r} {n}")


def test_mesh_train_step_refuses_mismatches(job):
    """make_sharded_train_step with a mesh refuses a model built without
    that mesh's split, and a group beside the mesh."""
    _, ranks = job
    for out in ranks:
        assert len(out["refused"]) == 2
        assert "volume_sharding" in out["refused"][0] and "not both" in out["refused"][1]


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_conv_transpose_without_relu_split_matches_jax(job, mode):
    """ConvTransposeBnReLU3D(relu=False), Hourglass3d's decoder stage, on
    each sweep rank's half of D (one upper halo plane; in train mode the
    BatchNorm reduced over the sweep group) against the unsplit block in
    f64 (1e-10 x the largest value) and against the JAX block with
    relu=False in f32 (1e-4 x max|y|): the output, negative values kept,
    and in train mode the running statistics."""
    task, ranks = job
    block = ConvTransposeBnReLU3D(*DECONV_CHANNELS, relu=False).double()
    block.load_state_dict(task["deconv_state"])
    block.train(mode == "train")
    with torch.no_grad():
        want = block(task["deconv_x"])
    jblock, jvars = _deconv_jax()
    x_last = jnp.asarray(np.moveaxis(_deconv_x(), 1, -1))
    if mode == "train":
        jy, upd = jblock.apply(jvars, x_last, train=True, mutable=["batch_stats"])
        jstats = jax.device_get(upd["batch_stats"])["bn"]
    else:
        jy = jblock.apply(jvars, x_last, train=False)
    jy = torch.from_numpy(np.moveaxis(np.asarray(jy), -1, 1).copy())
    assert want.min() < 0
    L = want.shape[2] // 2
    for r, out in enumerate(ranks):
        got = out["deconv"][mode]
        s = out["coords"][2][1]
        _close(got["y"], want[:, :, s * L : (s + 1) * L], 1e-10, f"rank {r} output")
        _close(got["y"], jy[:, :, s * L : (s + 1) * L], 1e-4, f"rank {r} output against JAX")
        if mode == "train":
            for n, b in block.named_buffers():
                _close(got["buffers"][n], b, 1e-10, f"rank {r} {n}")
            for n, key in (("1.running_mean", "mean"), ("1.running_var", "var")):
                _close(got["buffers"][n], torch.from_numpy(np.array(jstats[key])), 1e-4, f"rank {r} {n} against JAX")
