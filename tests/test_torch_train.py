"""The port's training runtime against the JAX package's, on the CPU: BatchNorm
in training mode, the loss and metrics, the LR schedule, one whole train
step from the same variables and batch, the checkpoint round trip, and the
training CLI. Built on tests/test_train.py's rig (3 views, 32x32 images, a
few depth planes)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu import models as jmodels
from scene_3dreconstruction_mvsnet_tpu.data import find_dataset_def
from scene_3dreconstruction_mvsnet_tpu.data.synthetic import SyntheticRig, make_blender_tree, make_dtu_tree, write_scan_list
from scene_3dreconstruction_mvsnet_tpu.interop import export_torch_state_dict, import_torch_state_dict
from scene_3dreconstruction_mvsnet_tpu.interop.torch_import import load_torch_checkpoint
from scene_3dreconstruction_mvsnet_tpu.models import blocks as jblocks
from scene_3dreconstruction_mvsnet_tpu.train import TrainState
from scene_3dreconstruction_mvsnet_tpu.train import depth_metrics as j_depth_metrics
from scene_3dreconstruction_mvsnet_tpu.train import make_optimizer as j_make_optimizer
from scene_3dreconstruction_mvsnet_tpu.train import make_train_step as j_make_train_step
from scene_3dreconstruction_mvsnet_tpu.train import multistep_lr as j_multistep_lr
from scene_3dreconstruction_mvsnet_tpu_torch import train_cli
from scene_3dreconstruction_mvsnet_tpu_torch.interop import load_jax_variables
from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, mvsnet_loss
from scene_3dreconstruction_mvsnet_tpu_torch.train import (
    depth_metrics,
    find_latest,
    make_optimizer,
    make_scheduler,
    make_train_step,
    multistep_factor,
    parse_lrepochs,
    restore_checkpoint,
    save_checkpoint,
)
from tests.test_models_parity import _rand_state_dict
from tests.test_train import _batch

from jax import tree_util

torch.set_num_threads(1)

LR = 1e-3


@pytest.fixture
def variables(rng):
    return import_torch_state_dict(_rand_state_dict(rng))


@pytest.mark.parametrize("net,block", [("feature", "conv2"), ("cost_regularization", "conv1"),
                                       ("cost_regularization", "conv9")])
def test_train_mode_batchnorm_matches_flax(rng, variables, net, block):
    """A conv+BN(+ReLU) block in training mode: output and updated running
    mean and variance (flax's biased batch variance) at rtol 1e-5, plus an
    atol of 1e-5 x the tensor's largest magnitude for values near zero
    (sums over the batch are taken in another order)."""
    port = load_jax_variables(MVSNet(), variables)
    mod = getattr(getattr(port, net), block).train()
    sub = {"params": variables["params"][net][block], "batch_stats": variables["batch_stats"][net][block]}
    if net == "feature":  # FeatureNet conv2: 5x5 stride 2, 8 -> 16, NHWC in JAX
        x = rng.rand(3, 12, 16, 8).astype(np.float32)
        jmod, perm, inv = jblocks.ConvBnReLU(16, 5, 2, 2), (0, 3, 1, 2), (0, 2, 3, 1)
    elif block == "conv1":  # CostRegNet conv1: 3x3x3 stride 2, 8 -> 16
        x = rng.rand(2, 4, 6, 8, 8).astype(np.float32)
        jmod, perm, inv = jblocks.ConvBnReLU3D(16, stride=2), (0, 4, 1, 2, 3), (0, 2, 3, 4, 1)
    else:  # CostRegNet conv9: transposed 3D conv 32 -> 16
        x = rng.rand(2, 2, 3, 4, 32).astype(np.float32)
        jmod, perm, inv = jblocks.ConvTransposeBnReLU3D(16), (0, 4, 1, 2, 3), (0, 2, 3, 4, 1)
    ref, mutated = jmod.apply(sub, jnp.asarray(x), train=True, mutable=["batch_stats"])
    out = mod(torch.from_numpy(x).permute(*perm)).permute(*inv).detach().numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    bn = mod.bn if hasattr(mod, "bn") else mod[1]
    stats = mutated["batch_stats"]["bn"]
    for ours, want in ((bn.running_mean, stats["mean"]), (bn.running_var, stats["var"])):
        want = np.asarray(want)
        np.testing.assert_allclose(ours.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_loss_and_metrics_match_jax(rng):
    est = (rng.rand(3, 8, 10) * 10).astype(np.float32)
    gt = (rng.rand(3, 8, 10) * 10).astype(np.float32)
    gt[0, :2] = est[0, :2] + 0.3  # some errors inside the quadratic branch
    mask = (rng.rand(3, 8, 10) > 0.3).astype(np.float32)
    mask[2] = 0.0  # an image with no valid pixel counts as 0
    tt = [torch.from_numpy(a) for a in (est, gt, mask)]
    jj = [jnp.asarray(a) for a in (est, gt, mask)]
    np.testing.assert_allclose(float(mvsnet_loss(*tt)), float(jmodels.mvsnet_loss(*jj)), rtol=1e-6)
    ours, ref = depth_metrics(*tt), j_depth_metrics(*jj)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-6, err_msg=k)


def test_multistep_lr_matches_jax():
    """The per-step factor, and the scheduler stepping the optimizer, equal
    the JAX schedule at and around each milestone step (the step exactly on
    a milestone already takes the lower rate)."""
    spec, spe = "2,3,4:1.2", 10
    assert parse_lrepochs(spec) == ([2, 3, 4], 1.0 / 1.2)
    factor, ref = multistep_factor(spec, spe), j_multistep_lr(LR, spec, spe)
    steps = (0, 1, 19, 20, 21, 29, 30, 31, 39, 40, 41, 100)
    for s in steps:
        assert LR * factor(s) == pytest.approx(float(ref(s)), rel=1e-6), s
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=LR)
    sched = make_scheduler(opt, spec, spe)
    seen = {}
    for s in range(101):
        seen[s] = opt.param_groups[0]["lr"]  # the lr the update at step s uses
        opt.step()
        sched.step()
    for s in steps:
        assert seen[s] == pytest.approx(float(ref(s)), rel=1e-6), s


@pytest.fixture(scope="module")
def train_batch(tmp_path_factory):
    """Two samples of tests/test_train.py's rig (3 views, 32x32 images) with
    16 depth planes, so the deepest CostRegNet level keeps 2 positions per
    sample for its batch statistics."""
    root = str(tmp_path_factory.mktemp("torch_train_ds"))
    make_blender_tree(root, scan="scene_000", n_lights=1, rig=SyntheticRig(n_views=3, img_hw=(32, 32), baseline=4.0),
                      ndepths=16)
    write_scan_list(os.path.join(root, "list.txt"), ["scene_000"])
    ds = find_dataset_def("blender")(root, os.path.join(root, "list.txt"), "train", nviews=3, ndepths=16,
                                     interval_scale=1.0, Nlights="0:1")
    return {k: np.asarray(v) for k, v in _batch(ds, [0, 1]).items()}


def test_train_step_matches_jax(train_batch):
    """One train step of the port against the JAX package's make_train_step
    of MVSNet() from the same variables and batch: the loss, every parameter
    gradient (JAX's from Adam's first moment, mu = 0.1 g), the BatchNorm
    running statistics and the parameters after Adam.

    The JAX step runs with 64-bit floats (its sweep and regression still
    cast to f32), and the port's model runs it in f64 and in f32. In f32 the
    training gradient at these sizes is ill-conditioned in both packages:
    measured here, the f32 gradients of each are 1-7 % off their own f64
    ones (flax's E[x^2] - E[x]^2 variance adds to JAX's), while the two f64
    gradients agree to 1e-4. So the port's f64 gradients are held to the
    f64 reference at 1e-3 x max|g| per tensor, and its f32 ones at
    0.1 x max|g|, which a flipped or dropped term still breaks.

    Adam's first step moves a parameter by lr * g / (|g| + eps): by lr in
    the sign of g wherever |g| is far above eps. Every parameter is held
    within that one step (2 x lr); where the reference gradient is larger
    than the gradient tolerance and than 1e-5 (1000 x eps), so that its
    sign is certain, at 1e-2 x lr, which sees the update's direction."""
    _train_step_against_jax(train_batch, refine=False, runs=((torch.float64, 1e-3), (torch.float32, 0.1)))


@pytest.fixture(scope="module")
def five_view_batch(tmp_path_factory):
    """Two samples at the train_BlenderDS preset's views and light sampling:
    5 views (a reference and 4 sources) of a 7-light blender tree, 3 of the
    7 lights drawn per viewpoint by the seeded ``Nlights 3:7`` draw, 16
    depth planes at its interval scale 1.33."""
    root = str(tmp_path_factory.mktemp("torch_train_v5"))
    make_blender_tree(root, scan="scene_000", n_lights=7, rig=SyntheticRig(n_views=5, img_hw=(32, 32), baseline=3.0),
                      ndepths=16)
    write_scan_list(os.path.join(root, "list.txt"), ["scene_000"])
    ds = find_dataset_def("blender")(root, os.path.join(root, "list.txt"), "train", nviews=5, ndepths=16,
                                     interval_scale=1.33, Nlights="3:7", seed=4)
    lights = [light for _, light, _, _ in ds.metas]
    assert len(ds) == 15 and len(set(lights)) > 1 and max(lights) < 7
    return {k: np.asarray(v) for k, v in _batch(ds, [0, 4]).items()}


def test_train_step_matches_jax_at_five_views(five_view_batch):
    """test_train_step_matches_jax at the train_BlenderDS preset's 5 views on
    a batch with sampled lights: the paired sweep's view sum has 4 source
    terms, not 2. The same tolerances: f64 gradients at 1e-3 x max|g|, f32
    at 0.1 x max|g|, and the f64 run's BatchNorm running statistics at rtol
    1e-4. The f32 run's running statistics are not held: measured here, the
    port's own f32 running mean of CostRegNet's conv7 is 1.4e-4 x max off
    its f64 one (the f32 rounding grows down the U-Net, conv4 2.4e-5 to
    conv7 1.4e-4), past the 1e-4 that the 3-view batch keeps."""
    assert five_view_batch["imgs"].shape[:2] == (2, 5)
    _train_step_against_jax(five_view_batch, refine=False, runs=((torch.float64, 1e-3), (torch.float32, 0.1)),
                            f32_buffers=False)


def test_refine_train_step_matches_jax(train_batch):
    """test_train_step_matches_jax with the refinement head, in f64: the loss
    is taken on ``refined_depth``, the metrics and ``depth_est`` on
    ``depth``, and the refinement head's 12 parameters get their gradients
    and updates with the others'."""
    model = _train_step_against_jax(train_batch, refine=True, runs=((torch.float64, 1e-3),))
    assert all(p.grad.abs().max() > 0 for n, p in model.named_parameters() if n.startswith("refine_network."))


def _train_step_against_jax(batch, refine, runs, remat=False, f32_buffers=True):
    """One train step of MVSNet(refine, remat) in each (dtype, gradient
    tolerance) of ``runs`` against the JAX package's; returns the last run's
    model. ``f32_buffers=False`` leaves out the f32 run's BatchNorm running
    statistics (the f64 run's are held)."""
    jmodel = jmodels.MVSNet(refine=refine, remat=remat)
    jvars = jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    )
    with jax.enable_x64(True):
        f64 = lambda t: tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), t)  # noqa: E731
        state = TrainState.create(f64(jvars), j_make_optimizer(lambda step: LR))
        new_state, jaux = jax.device_get(j_make_train_step(jmodel)(state, f64(batch)))
    jgrads = export_torch_state_dict({"params": tree_util.tree_map(lambda m: m / 0.1, new_state.opt_state[0].mu),
                                      "batch_stats": new_state.batch_stats})
    jnew = export_torch_state_dict(new_state.variables)
    largest = max(np.abs(g).max() for g in jgrads.values())

    for dtype, g_tol in runs:
        model = load_jax_variables(MVSNet(refine=refine, dtype=dtype if dtype == torch.float64 else None,
                                          remat=remat), jvars).to(dtype)
        opt = make_optimizer(model, LR)
        step = make_train_step(model, opt, make_scheduler(opt, "10:2", 100), "cpu")
        aux = step({k: v.astype(np.float64 if dtype == torch.float64 else np.float32) for k, v in batch.items()})

        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-4)
        np.testing.assert_allclose(aux["depth_est"].numpy(), np.asarray(jaux["depth_est"]),
                                   atol=1e-3 * float(np.ptp(batch["depth_values"])))
        params = dict(model.named_parameters())
        assert len(params) == 55 + 12 * refine  # 23 in FeatureNet, 32 in CostRegNet, 12 in RefineNet
        for name, p in params.items():
            g, want = p.grad.double().numpy(), jgrads["module." + name]
            new, want_new = p.detach().double().numpy(), jnew["module." + name]
            np.testing.assert_allclose(new, want_new, atol=2 * LR, err_msg=name)
            if name == "cost_regularization.prob.bias":
                # the softmax over depth ignores a constant shift of the
                # logits: this gradient is 0 up to rounding on both sides
                assert np.abs(g).max() < 1e-5 * largest and np.abs(want).max() < 1e-5 * largest
                continue
            np.testing.assert_allclose(g, want, atol=g_tol * np.abs(want).max(), err_msg=name)
            sure = (np.abs(want) > g_tol * np.abs(want).max()) & (np.abs(want) > 1e-5)
            assert sure.any(), name
            np.testing.assert_allclose(new[sure], want_new[sure], atol=1e-2 * LR, err_msg=name)
        for name, buf in model.named_buffers():  # rtol 1e-4, with 1e-4 x max for means near 0
            if name.endswith(("running_mean", "running_var")) and (f32_buffers or dtype == torch.float64):
                want = jnew["module." + name]
                np.testing.assert_allclose(buf.double().numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                           err_msg=name)
    return model


def test_checkpoint_round_trip(tmp_path, rng, variables):
    """save, then resume into a fresh model and optimizer: the same
    parameters, optimizer state, epoch and next learning rate."""
    model = load_jax_variables(MVSNet(), variables)
    opt = make_optimizer(model, LR)
    sched = make_scheduler(opt, "1:2", 3)
    for _ in range(4):  # three steps cross the epoch-1 milestone
        for p in model.parameters():
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        opt.step()
        sched.step()
    logdir = str(tmp_path / "log")
    save_checkpoint(logdir, 0, model, opt)
    save_checkpoint(logdir, 2, model, opt)
    assert find_latest(logdir).endswith("model_000002.ckpt")

    fresh = MVSNet()
    fresh_opt = make_optimizer(fresh, LR)
    fresh_sched = make_scheduler(fresh_opt, "1:2", 3)
    assert restore_checkpoint(find_latest(logdir), fresh, fresh_opt, fresh_sched) == 3
    for (k, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    for a, b in zip(opt.state.values(), fresh_opt.state.values()):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert fresh_sched.last_epoch == sched.last_epoch == 4
    assert fresh_opt.param_groups[0]["lr"] == pytest.approx(LR / 2)
    fresh_opt.step()
    fresh_sched.step()
    assert fresh_opt.param_groups[0]["lr"] == pytest.approx(LR / 2)


def test_train_cli_writes_a_reference_checkpoint(tmp_path, capsys):
    """Two training steps through the CLI on a synthetic DTU tree, then a
    test pass; the checkpoint loads in the JAX package and resumes."""
    root = str(tmp_path / "dtu")
    make_dtu_tree(root, rig=SyntheticRig(n_views=3, img_hw=(32, 32), baseline=4.0), ndepths=8)  # 8 planes at 1.06
    write_scan_list(os.path.join(root, "list.txt"), ["scan1"])
    logdir = str(tmp_path / "log")
    args = ["--mode", "train", "--dataset", "dtu_yao", "--trainpath", root,
            "--trainlist", os.path.join(root, "list.txt"), "--testlist", os.path.join(root, "list.txt"),
            "--epochs", "1", "--batch_size", "10", "--numdepth", "8", "--interval_scale", "1.06",
            "--NtrainViews", "3", "--NtestViews", "3", "--logdir", logdir, "--summary_freq", "1",
            "--seed", "1", "--num_workers", "0", "--device", "cpu"]
    train_cli.main(args)
    out = capsys.readouterr().out
    assert "Iter 1/2" in out and "avg_test_scalars" in out  # 21 samples: 2 steps of 10
    ckpt = find_latest(logdir)
    assert ckpt.endswith("model_000000.ckpt")
    variables = load_torch_checkpoint(ckpt)
    assert variables["params"]["cost_regularization"]["prob"]["kernel"].shape == (3, 3, 3, 8, 1)
    assert os.path.exists(os.path.join(logdir, "scalars.jsonl"))

    train_cli.main(args + ["--resume", "--epochs", "1"])  # nothing left to train
    assert "Resuming from" in capsys.readouterr().out
    for flag in (["--pallas_sweep"], ["--plan_check", "raise"], ["--flat_costreg"]):
        with pytest.raises(SystemExit):
            train_cli.main(args + flag)


ACCEPTED = [  # train.py's flags that the port runs, once refused
    (["--model", "mvsnet"], {"model": "mvsnet"}),
    (["--refine"], {"refine": True}),
    (["--debug_MVSnet", "2"], {"debug_MVSnet": 2}),
    (["--mode", "profile"], {"mode": "profile"}),
    (["--remat"], {"remat": True}),
    (["--multihost"], {"multihost": True}),
    (["--img_cache", "cache"], {"img_cache": "cache"}),
]


@pytest.mark.parametrize("argv,reason", [([flag], why) for flag, why in train_cli.REFUSED.items()]
                         + [(argv, None) for argv, _ in ACCEPTED])
def test_train_cli_parser_refuses_with_reasons(capsys, argv, reason):
    """train.py's flags that the port does not run are refused with their
    reason; --model mvsnet (train.py's, unused), --refine, --debug_MVSnet,
    --mode profile, --remat, --multihost and --img_cache are accepted."""
    parser = train_cli.build_parser()
    if reason is None:
        args = vars(parser.parse_args(argv))
        want = next(w for a, w in ACCEPTED if a == argv)
        assert {k: args[k] for k in want} == want
        assert all(args[k] == parser.get_default(k)
                   for k in ("mode", "model", "refine", "debug_MVSnet", "remat", "multihost", "img_cache")
                   if k not in want)
        return
    with pytest.raises(SystemExit):
        parser.parse_args(argv)
    assert f"{' '.join(argv)} is not supported by the PyTorch port: {reason}" in capsys.readouterr().err
