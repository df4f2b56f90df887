"""The port's run recipes (``recipes.py``) against ``configs/workloads.json``
and the ``scripts/*.sh`` that run its presets, and the runner on the CPU at
a tiny size: the train_BlenderDS preset for one step at its 5 views with 3
of 7 lights, and the eval_binpicking and eval_BlenderDS presets on the bin
and bds8 registries' own layouts."""

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu.data.synthetic import RingRig, SyntheticRig, make_blender_tree, write_scan_list
from scene_3dreconstruction_mvsnet_tpu.io.cams import write_pair_file
from scene_3dreconstruction_mvsnet_tpu_torch import eval_cli, recipes, train_cli
from scene_3dreconstruction_mvsnet_tpu_torch.io import read_pfm, read_ply
from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
from scene_3dreconstruction_mvsnet_tpu_torch.train import load_model
from tests.test_torch_io import BDS8_PAIRFILE, BDS8_VIEWS, registry_tree

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKLOADS = json.loads((REPO / "configs" / "workloads.json").read_text())
CLIS = {"train.py": train_cli, "eval.py": eval_cli}
PATH_FLAGS = {"--trainpath", "--logdir", "--testpath", "--loadckpt", "--outdir"}


def _cli(name):
    return {"train_cli": train_cli, "eval_cli": eval_cli}[recipes.PRESETS[name]["cli"]]


@pytest.mark.parametrize("name", [k for k in WORKLOADS if not k.startswith("_")])
def test_preset_matches_workloads_json(name):
    """Each preset names the port's counterpart of its CLI and holds the same
    args; its argv, parsed by that CLI's own parser, gives each of them,
    after the parser's type conversion."""
    preset = WORKLOADS[name]
    assert set(recipes.PRESETS) == {k for k in WORKLOADS if not k.startswith("_")}
    assert _cli(name) is CLIS[preset["cli"]]
    assert recipes.PRESETS[name]["args"] == preset["args"]
    args = vars(_cli(name).build_parser().parse_args(recipes.preset_argv(name)))
    for key, value in preset["args"].items():
        assert args[key] == value and type(args[key]) is type(value), key


def _script_flags(text):
    """The ``--flag[=value]`` lines of a script's command, in order, the
    quotes dropped: [(flag, value or None)]."""
    return [(m.group(1), m.group(3)) for m in re.finditer(r'^\s*(--\w+)(?:=("?)(.*?)\2)?\s*\\\s*$', text, re.M)]


@pytest.mark.parametrize("name", list(recipes.SCRIPTS))
def test_script_matches_preset(capsys, name):
    """Each shell script, read as text, runs its preset: its flags without
    the path flags and the TPU flags parse to what the preset's argv parses
    to (plus eval_DTU.sh's --dtype=bfloat16), each TPU flag is one the
    port's parser refuses with its reason, and its path flags, their
    environment variables and defaults and its log are the runner's."""
    script = recipes.SCRIPTS[name]
    text = (REPO / script.path).read_text()
    flags = _script_flags(text)
    cli = _cli(name)
    tpu = [f for f, _ in flags if f in cli.REFUSED]
    assert tpu and all(v is None for f, v in flags if f in cli.REFUSED)
    paths = {f: v for f, v in flags if f in PATH_FLAGS}
    kept = [f if v is None else f"{f}={v}" for f, v in flags if f not in PATH_FLAGS and f not in cli.REFUSED]
    extra = ["--dtype=bfloat16"] if name == "eval_DTU" else []
    parser = cli.build_parser()
    assert vars(parser.parse_args(kept)) == vars(parser.parse_args(recipes.preset_argv(name) + extra))
    assert {f.split("=")[0] for f in kept} == {f"--{k}" for k in recipes.PRESETS[name]["args"]} | {"--dtype"}
    # the paths: "$VAR" for each flag, VAR=${VAR:-"default"} (or ${VAR:?...}: required)
    defaults = dict(re.findall(r'^(\w+)=\$\{\1:-"([^"]*)"\}', text, re.M))
    required = set(re.findall(r'^(\w+)=\$\{\1:\?', text, re.M))
    assert paths == {f: f"${var}" for f, var, _ in script.paths}
    for _, var, default in script.paths:
        assert (var in required) if default is None else defaults[var] == default, var
    log_flag, log_name = script.log
    log_var = next(var for f, var, _ in script.paths if f == log_flag)
    assert f'tee "${log_var}/{log_name}"' in text and '"$@"' in text
    for flag in tpu:
        with pytest.raises(SystemExit):
            parser.parse_args([flag])
        assert f"{flag} is not supported by the PyTorch port: {cli.REFUSED[flag]}" in capsys.readouterr().err


def test_registries_match_eval_py():
    """eval_cli's per-dataset registries are eval.py's."""
    spec = importlib.util.spec_from_file_location("eval_py", REPO / "eval.py")
    eval_py = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eval_py)
    for table in ("DICT_CAM_SUBFOLDER", "DICT_IMG_SUBFOLDER", "DICT_IMG_RES"):
        assert getattr(eval_cli, table) == getattr(eval_py, table), table


def test_runner_applies_the_callers_flags_last(monkeypatch, tmp_path):
    """The runner hands the CLI the preset's flags, the script's path flags
    from the environment (or their defaults), then the caller's, so the
    caller's win; it writes the run's output to the script's log, and
    refuses a missing CKPT and an unknown preset."""
    seen = []

    def fake_main(argv):
        seen.append(argv)
        print("the CLI ran")
        return "result"

    monkeypatch.setattr(train_cli, "main", fake_main)
    monkeypatch.setenv("LOGDIR", str(tmp_path / "log"))
    monkeypatch.delenv("DTU_TRAINING", raising=False)
    assert recipes.main(["train_DTU", "--epochs", "1", "--trainpath", "mine"]) == "result"
    argv = seen[-1]
    assert argv[:len(recipes.preset_argv("train_DTU"))] == recipes.preset_argv("train_DTU")
    assert argv[-4:] == ["--epochs", "1", "--trainpath", "mine"]
    assert "--trainpath=./data/dtu_training" in argv and f"--logdir={tmp_path / 'log'}" in argv
    args = train_cli.build_parser().parse_args(argv)
    assert (args.epochs, args.trainpath, args.logdir) == (1, "mine", str(tmp_path / "log"))
    assert (tmp_path / "log" / "train.log").read_text() == "the CLI ran\n"

    monkeypatch.setattr(eval_cli, "main", fake_main)
    monkeypatch.delenv("CKPT", raising=False)
    with pytest.raises(SystemExit, match="CKPT"):
        recipes.main(["eval_DTU"])
    assert recipes.main(["eval_binpicking", "--photomask", "0.3"]) == "result"  # no script: no paths, no log
    assert seen[-1] == recipes.preset_argv("eval_binpicking") + ["--photomask", "0.3"]
    with pytest.raises(SystemExit, match="presets: train_DTU"):
        recipes.main(["train_dtu"])


def test_runner_trains_the_blender_preset_on_the_cpu(monkeypatch, tmp_path):
    """train_BlenderDS through the runner for one step at its 5 views, batch
    3, 3 of 7 lights, 192 planes and interval scale 1.33 (a 5-view blender
    tree with 7 lights at 32x32 whose pair file keeps one reference view:
    3 samples), its tree and log directory from BDS8_TRAINING and LOGDIR:
    the step's loss and the test pass are finite, train.log holds the run,
    and the checkpoint loads back strict."""
    root = tmp_path / "bds8"
    rig = SyntheticRig(n_views=5, img_hw=(32, 32), baseline=3.0)
    make_blender_tree(str(root), scan="scene_000", n_lights=7, rig=rig, ndepths=192)
    write_pair_file(str(root / "Cameras_512x640" / "pair.txt"), rig.pair_list()[:1])
    write_scan_list(str(root / "list.txt"), ["scene_000"])
    monkeypatch.setenv("BDS8_TRAINING", str(root))
    monkeypatch.setenv("LOGDIR", str(tmp_path / "log"))
    recipes.main(["train_BlenderDS", "--trainlist", str(root / "list.txt"), "--testlist", str(root / "list.txt"),
                  "--epochs", "1", "--num_workers", "0", "--seed", "1", "--device", "cpu"])
    log = (tmp_path / "log" / "train.log").read_text()
    table = dict(re.findall(r"^(\w+) *\t(.*?) *\t<class", log, re.M))  # train_cli's print_args rows
    assert table["NtrainViews"] == "5" and table["Nlights"] == "3:7" and table["lr"] == "5e-06"
    assert "Epoch 0/1, Iter 0/1" in log and "(3 samples" in log
    loss = float(re.search(r"Iter 0/1, LR:[^,]*, loss=([^,]+)", log).group(1))
    test = re.search(r"avg_test_scalars: \{'loss': ([^,]+)", log)
    assert np.isfinite(loss) and test and np.isfinite(float(test.group(1)))
    load_model(str(tmp_path / "log" / "model_000000.ckpt"), MVSNet())


@pytest.mark.parametrize("name", ["eval_binpicking", "eval_BlenderDS"])
def test_runner_evaluates_registry_presets_on_the_cpu(monkeypatch, tmp_path, name):
    """eval_binpicking and eval_BlenderDS through the runner on their
    registries' own layouts (the bin's pair file two directories above
    --testpath; bds8's eval_pair_4x4_30-34-46-47.txt pairing views 30, 34,
    46 and 47 of a 49-camera ring) and their presets' own scene lists, f32,
    the preset's views, planes and filter, the images cut to 32x64: every
    depth map, confidence map, mask and the PLY are written."""
    dataset_name = recipes.PRESETS[name]["args"]["dataset_name"]
    scan = {"bin": "binpicking", "bds8": "scene_000"}[dataset_name]
    assert (REPO / recipes.PRESETS[name]["args"]["testlist"]).read_text().split() == [scan]
    views = BDS8_VIEWS if dataset_name == "bds8" else range(4)
    testpath = registry_tree(tmp_path / "acq", dataset_name, RingRig(n_views=49 if dataset_name == "bds8" else 4,
                                                                     img_hw=(32, 64)), scan, 192, views=views,
                             pairfile=BDS8_PAIRFILE if dataset_name == "bds8" else "pair.txt")
    model = random_init_(MVSNet(), torch.Generator().manual_seed(0))
    torch.save({"model": {"module." + k: v for k, v in model.state_dict().items()}}, tmp_path / "model.ckpt")
    monkeypatch.chdir(REPO)  # the presets' scene lists are relative to the checkout, as in the scripts
    out = recipes.main([name, "--testpath", str(testpath), "--loadckpt", str(tmp_path / "model.ckpt"), "--outdir",
                        str(tmp_path / "out"), "--img_res", "32", "64", "--num_workers", "0", "--device", "cpu"])
    assert out["stage_a"]["n_views"] == 4 and len(out["stage_b"]) == 1
    acq = tmp_path / "out" / testpath.name
    for v in views:
        depth = read_pfm(str(acq / scan / "depth_est" / f"{v:0>8}.pfm"))[0]
        assert depth.shape == (8, 16) and np.isfinite(depth).all()
        assert read_pfm(str(acq / scan / "confidence" / f"{v:0>8}.pfm"))[0].shape == (8, 16)
        assert all((acq / scan / "mask" / f"{v:0>8}_{k}.png").exists() for k in ("photo", "geo", "final"))
    read_ply(str(acq / "mvsnet000_l3.ply"))
