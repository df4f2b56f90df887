"""The rest of the port's training against the JAX package's, on the CPU: the
summary logger, the train-time ``--debug_MVSnet`` dumps, profile mode, and
``train_cli`` with ``--refine``, ``--debug_MVSnet`` and ``--mode profile``.
Built on the synthetic DTU tree of tests/test_torch_train.py (3 views, 32x32
images, 8 planes)."""

import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from scene_3dreconstruction_mvsnet_tpu.data.synthetic import SyntheticRig, make_dtu_tree, write_scan_list
from scene_3dreconstruction_mvsnet_tpu.interop import import_torch_state_dict
from scene_3dreconstruction_mvsnet_tpu.models import MVSNet as JaxMVSNet
from scene_3dreconstruction_mvsnet_tpu.train.logging import SummaryLogger as JaxSummaryLogger
from scene_3dreconstruction_mvsnet_tpu.utils.debug_dump import debug_forward as jax_debug_forward
from scene_3dreconstruction_mvsnet_tpu_torch import train_cli
from scene_3dreconstruction_mvsnet_tpu_torch.data import find_dataset_def
from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
from scene_3dreconstruction_mvsnet_tpu_torch.train.logging import SummaryLogger
from scene_3dreconstruction_mvsnet_tpu_torch.train.loop import Trainer
from scene_3dreconstruction_mvsnet_tpu_torch.utils.debug_dump import debug_forward

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dtu(tmp_path_factory):
    """A synthetic DTU training tree (3 views x 7 lights = 21 samples)."""
    root = tmp_path_factory.mktemp("dtu_extras")
    make_dtu_tree(str(root), rig=SyntheticRig(n_views=3, img_hw=(32, 32), baseline=4.0), ndepths=8)
    write_scan_list(str(root / "list.txt"), ["scan1"])
    return root


def _datasets(root):
    cls = find_dataset_def("dtu_yao")
    args = (str(root / "list.txt"),)
    return (cls(str(root), *args, "train", 3, 8, 1.06, seed=1), cls(str(root), *args, "test", 3, 8, 1.06, seed=1))


def _trainer(root, logdir, model, **kw):
    return Trainer(model, *_datasets(root), logdir=str(logdir), epochs=1, batch_size=10, summary_freq=1,
                   num_workers=0, seed=1, device="cpu", **kw)


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def test_summary_logger_matches_jax(tmp_path):
    """The same scalars through both loggers give the same scalars.jsonl
    records but for their times; each writes a TensorBoard event file, which
    the image summaries add to."""
    calls = [("train", {"loss": 1.5, "abs_depth_error": np.float32(0.25)}, 0),
             ("test", {"loss": 2.0, "thres2mm_error": 0.5}, 3), ("fulltest", {"loss": 1.25}, 4)]
    for name, cls in (("jax", JaxSummaryLogger), ("port", SummaryLogger)):
        logger = cls(str(tmp_path / name))
        for mode, values, step in calls:
            logger.save_scalars(mode, values, step)
        logger.close()
    ours, want = _records(tmp_path / "port" / "scalars.jsonl"), _records(tmp_path / "jax" / "scalars.jsonl")
    assert ours == want and ours[1] == {"mode": "test", "step": 3, "loss": 2.0, "thres2mm_error": 0.5}
    events = glob.glob(str(tmp_path / "port" / "events.out.tfevents.*"))
    assert len(events) == 1
    size = os.path.getsize(events[0])
    logger = SummaryLogger(str(tmp_path / "port"))
    logger.save_images("train", {"depth_est": np.random.rand(8, 8), "ref_img": np.random.rand(32, 32, 3)}, 5)
    logger.close()
    assert sum(os.path.getsize(p) for p in glob.glob(str(tmp_path / "port" / "events.out.tfevents.*"))) > size


def _bn_buffers(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k or "num_batches" in k}


def test_debug_forward_keeps_training_state(tmp_path):
    """A dump from a model in training mode normalises with the running
    statistics, leaves every buffer as it was and the model in training
    mode; its warp dumps are written."""
    model = random_init_(MVSNet(), torch.Generator().manual_seed(0)).train()
    before = _bn_buffers(model)
    gen = torch.Generator().manual_seed(1)
    imgs = torch.randint(0, 256, (1, 3, 32, 32, 3), generator=gen, dtype=torch.uint8)
    projs = torch.eye(4).repeat(1, 3, 1, 1)
    projs[0, :, :3, :3] = torch.tensor([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]])
    projs[0, 1, 0, 3], projs[0, 2, 1, 3] = 4.0, -4.0
    debug_forward(model, imgs, projs, torch.linspace(40.0, 60.0, 8)[None], 2, str(tmp_path))
    assert model.training
    for k, v in _bn_buffers(model).items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    assert len(glob.glob(str(tmp_path / "debug" / "warped_v*.png"))) == 2 * 4 * 4  # 2 views, 4 planes, 4 channels


def _pngs(path):
    return {os.path.basename(p): np.asarray(Image.open(p)) for p in sorted(glob.glob(os.path.join(path, "*.png")))}


def test_debug_forward_divides_u8_images(tmp_path):
    """u8 images are dumped as the steps see them, divided by 255: bit 0's
    image and feature dumps equal those of the f32 images u8 / 255, and the
    JAX dump of the same f32 images."""
    model = random_init_(MVSNet(), torch.Generator().manual_seed(0))
    imgs = np.random.RandomState(0).randint(0, 256, (1, 2, 32, 32, 3)).astype(np.uint8)
    projs = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    dv = np.linspace(40.0, 60.0, 8, dtype=np.float32)[None]
    debug_forward(model, imgs, projs, dv, 1, str(tmp_path / "u8"))
    debug_forward(model, imgs.astype(np.float32) / 255.0, projs, dv, 1, str(tmp_path / "f32"))
    state = {"module." + k: v.numpy() for k, v in model.state_dict().items() if "num_batches" not in k}
    jax_debug_forward(JaxMVSNet(), import_torch_state_dict(state), imgs.astype(np.float32) / 255.0, projs, dv, 1,
                      str(tmp_path / "jax"))
    got, want, jax_dumps = (_pngs(tmp_path / d / "debug") for d in ("u8", "f32", "jax"))
    assert len(got) == 2 * (1 + 8) and got.keys() == want.keys() == jax_dumps.keys()
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert np.abs(got[name].astype(int) - jax_dumps[name]).max() <= 1, name  # a rounding step of the PNG


def test_jax_train_dump_feeds_u8_images_unscaled(tmp_path):
    """The JAX Trainer hands its u8 batch to debug_forward uncast (JAX
    ``train/loop.py:208-211``), and the JAX dump feeds it to FeatureNet as
    0-255 values: its feature dumps equal those of the f32 images times 255,
    not those of the images divided by 255. The port divides by 255."""
    model = random_init_(MVSNet(), torch.Generator().manual_seed(0))
    state = {"module." + k: v.numpy() for k, v in model.state_dict().items() if "num_batches" not in k}
    variables = import_torch_state_dict(state)
    imgs = np.random.RandomState(0).randint(0, 256, (1, 2, 32, 32, 3)).astype(np.uint8)
    projs = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    dv = np.linspace(40.0, 60.0, 8, dtype=np.float32)[None]
    for name, x in (("u8", imgs), ("raw", imgs.astype(np.float32)), ("scaled", imgs.astype(np.float32) / 255.0)):
        jax_debug_forward(JaxMVSNet(), variables, x, projs, dv, 1, str(tmp_path / name))
    u8, raw, scaled = (_pngs(tmp_path / d / "debug") for d in ("u8", "raw", "scaled"))
    feats = [n for n in u8 if n.startswith("feat_")]
    assert feats and all(np.array_equal(u8[n], raw[n]) for n in feats)
    assert any(not np.array_equal(u8[n], scaled[n]) for n in feats)


def test_trainer_summaries_and_dumps_leave_training_unchanged(dtu, tmp_path):
    """Two train steps (batch 10 of 21 samples) with a summary, images and a
    --debug_MVSnet 2 dump at each step, against the same steps with neither
    dumps nor images: every parameter, BatchNorm buffer and optimizer state
    after the two steps is identical, so the dumps changed neither the
    buffers nor the next step; each step's dumps and the scalars of both
    modes are written."""
    runs = {}
    for tag, debug in (("dumps", 2), ("plain", 0)):
        model = random_init_(MVSNet(), torch.Generator().manual_seed(0))
        trainer = _trainer(dtu, tmp_path / tag, model, debug_mvsnet=debug)
        if tag == "plain":
            trainer.logger.save_images = lambda *a: None
        trainer.train()
        runs[tag] = trainer
    a, b = runs["dumps"], runs["plain"]
    for k, v in a.model.state_dict().items():
        torch.testing.assert_close(v, b.model.state_dict()[k], rtol=0, atol=0, msg=k)
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    for step in (0, 1):
        assert len(glob.glob(str(tmp_path / "dumps" / "debug_train" / f"step{step:06d}" / "debug" / "warped_*.png"))) == 32
    assert not (tmp_path / "plain" / "debug_train").exists()
    recs = _records(tmp_path / "dumps" / "scalars.jsonl")
    assert [(r["mode"], r["step"]) for r in recs] == [("train", 0), ("train", 1), ("test", 2), ("fulltest", 2)]
    assert glob.glob(str(tmp_path / "dumps" / "events.out.tfevents.*"))


def test_trainer_profile_writes_a_trace(dtu, tmp_path, capsys):
    """Profile mode on the CPU: warm-up and traced eval steps, each timed,
    and a Chrome trace of the traced ones under <logdir>/profile/."""
    trainer = _trainer(dtu, tmp_path, random_init_(MVSNet(refine=True), torch.Generator().manual_seed(0)))
    path = trainer.profile(warmup_iters=2, profile_iters=1)
    assert path == str(tmp_path / "profile" / "trace.json")
    with open(path) as f:
        trace = json.load(f)
    assert any("conv2d" in e.get("name", "") for e in trace["traceEvents"])
    out = capsys.readouterr().out
    assert "WarmUp Iter 1, time = " in out and "Profile Iter 0, time = " in out


def test_train_cli_refine_debug_and_profile(dtu, tmp_path, capsys):
    """train_cli with --refine and --debug_MVSnet 2 trains an epoch with the
    refinement head and dumps, its checkpoint carries the head, and
    --mode profile on that checkpoint writes the trace."""
    logdir = str(tmp_path / "log")
    args = ["--dataset", "dtu_yao", "--trainpath", str(dtu), "--trainlist", str(dtu / "list.txt"), "--testlist",
            str(dtu / "list.txt"), "--epochs", "1", "--batch_size", "10", "--numdepth", "8", "--NtrainViews", "3",
            "--NtestViews", "3", "--logdir", logdir, "--summary_freq", "1", "--seed", "1", "--num_workers", "0",
            "--refine", "--device", "cpu"]
    train_cli.main(args + ["--mode", "train", "--debug_MVSnet", "2"])
    ckpt = os.path.join(logdir, "model_000000.ckpt")
    assert any(k.startswith("module.refine_network.") for k in torch.load(ckpt, weights_only=True)["model"])
    assert os.path.isdir(os.path.join(logdir, "debug_train", "step000001", "debug"))
    train_cli.main(args + ["--mode", "profile", "--loadckpt", ckpt])
    assert os.path.exists(os.path.join(logdir, "profile", "trace.json"))
    assert "Profiler trace written to" in capsys.readouterr().out
