"""The port's bench entry points (``scene_3dreconstruction_mvsnet_tpu_torch/
bench``) on the CPU at small sizes: their rigs byte for byte against the
JAX package's bench scripts, their JSON lines with every key of the
scripts' results, the headline rig's forward against the JAX package's, the
CLI log lines the end-to-end benches parse, and stage A's device-busy line.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu import models as jmodels
from scene_3dreconstruction_mvsnet_tpu.interop import export_torch_state_dict
from scene_3dreconstruction_mvsnet_tpu_torch.bench import configs, e2e_eval, headline, profile_input, rigs
from scene_3dreconstruction_mvsnet_tpu_torch.bench import train_e2e, train_step
from scene_3dreconstruction_mvsnet_tpu_torch.data.synthetic import SyntheticRig, make_eval_tree, write_scan_list
from scene_3dreconstruction_mvsnet_tpu_torch.eval.depth_gen import save_depth
from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--hw", "64", "96", "--numdepth", "16"]


def _load_root_script(path: Path):
    """A root script as a module (the bench scripts' module scope imports
    only numpy and the standard library, chip_smoke.py's only the standard
    library)."""
    spec = importlib.util.spec_from_file_location(f"_root_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the keys of the JAX scripts' results, as chip_smoke.py's bench phase holds the card's lines to them
SMOKE = _load_root_script(REPO / "chip_smoke.py")
HEADLINE_KEYS = SMOKE.BENCH_HEADLINE_KEYS
CONFIG_KEYS = {path[0]: keys for path, keys in SMOKE.BENCH_CONFIG_KEYS.items() if path}
E2E_RUN_KEYS = SMOKE.BENCH_E2E_RUN_KEYS
SERVE_KEYS = SMOKE.BENCH_E2E_EVAL_KEYS[("bin_serve_10scan",)]
TRAIN_E2E_KEYS = SMOKE.BENCH_TRAIN_E2E_KEYS
ON_A_CARD = {"device"}  # the card's name and power limit: None on the CPU
BUSY_RE = r"stage A = ([\d.]+)%"  # scripts/bench_e2e_eval.py:151


def _last_json(capsys) -> dict:
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    return json.loads(lines[-1])


def test_rigs_equal_the_scripts_byte_for_byte():
    """look_at and ring_projs against bench.py's _look_at and ring_projs,
    ring_rig and translation_rig against scripts/bench_configs.py's, at
    every rig the scripts build: the same f32 bytes."""
    jbench = _load_root_script(REPO / "bench.py")
    jconfigs = _load_root_script(REPO / "scripts" / "bench_configs.py")
    for eye, target in (((150.0, 0.0, -700.0), (0.0, 0.0, 700.0)), ((1.0, 2.0, 3.0), (-4.0, 5.0, 60.0))):
        want, got = jbench._look_at(eye, target), rigs.look_at(eye, target)
        assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()
        assert jconfigs.look_at(eye, target).tobytes() == got.tobytes()
    for h, w in ((864, 1152), (64, 96)):
        K = np.array([[w * 1.1, 0, w / 2], [0, w * 1.1, h / 2], [0, 0, 1]], np.float32) / 4.0
        want = jbench.ring_projs(49, [0, 1, 48, 2, 47], 150.0, -700.0, 700.0, K)
        got = rigs.ring_projs(49, [0, 1, 48, 2, 47], 150.0, -700.0, 700.0, K)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        K7 = np.array([[w * 0.7, 0, w / 8], [0, w * 0.7, h / 8], [0, 0, 1]], np.float32) / 4.0
        for n in (3, 5):
            assert rigs.translation_rig(n, 2.0, K7).tobytes() == jconfigs.translation_rig(n, 2.0, K7).tobytes()
    eye3 = np.eye(3, dtype=np.float32)
    for args in ((49, 150.0, -700.0, 700.0, K), (49, 50.0, -600.0, 600.0, eye3), (4, 120.0, -650.0, 650.0, K),
                 (4, 120.0, -650.0, 650.0, eye3)):
        want, got = jconfigs.ring_rig(*args), rigs.ring_rig(*args)
        assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("fused_conv0", [False, True], ids=["k1_k2", "k4"])
def test_headline_prints_bench_py_keys(tmp_path, capsys, fused_conv0):
    """The headline at 64x96 and 16 planes prints one JSON line with every
    key of bench.py's, plus backend and device (none on the CPU), and
    writes it under --out."""
    argv = SMALL + ["--iters", "2", "--out", str(tmp_path)] + (["--pallas_conv0"] if fused_conv0 else [])
    result = headline.main(argv)
    line = _last_json(capsys)
    assert line == json.loads(json.dumps(result))
    assert HEADLINE_KEYS <= set(line)
    assert line["platform"] == "cpu" and line["backend"] == "torch" and line["device"] is None
    assert line["value"] > 0 and abs(line["seconds_per_depthmap"] * line["value"] - 1) < 1e-9
    assert line["vs_baseline"] is None  # the CPU reference's number is for the headline's sizes only
    name = "headline_k4" if fused_conv0 else "headline"
    assert json.loads((tmp_path / f"{name}.json").read_text()) == line


def test_configs_print_bench_configs_keys(tmp_path, capsys):
    """The four configurations at 64x96 and 16 planes: every result key of
    scripts/bench_configs.py, each value finite and positive."""
    configs.main(SMALL + ["--iters", "2", "--out", str(tmp_path)])
    line = _last_json(capsys)
    assert line["platform"] == "cpu" and line["device"] is None
    for name, keys in CONFIG_KEYS.items():
        assert keys <= set(line[name]), name
        assert all(np.isfinite(line[name][k]) and line[name][k] > 0 for k in keys), name
    assert line["dtu_small_3v_96d_512x640"]["shape"] == "3v 16d 64x96"


@pytest.mark.parametrize("flags", [[], ["--sustained", "--remat"]], ids=["per_step", "sustained_remat"])
def test_train_step_prints_its_lines(tmp_path, capsys, flags):
    """The train step at 64x96 and 16 planes (batch 2): the script's lines,
    the sustained one in the shape bench/train_e2e.py reads, and one JSON
    line with the same numbers; --xla and --no-paired are refused."""
    res = train_step.main(SMALL + ["--batch", "2", "--out", str(tmp_path)] + flags)["train_step"]
    out = capsys.readouterr().out
    m = re.search(r"sustained .*: ([\d.]+) s/step", out)
    assert bool(m) == ("--sustained" in flags)
    if m:
        assert float(m.group(1)) == pytest.approx(res["s_per_step"], abs=1e-4)
    assert SMOKE.BENCH_TRAIN_STEP_KEYS | {"mode", "config", "sustained"} <= set(res)
    assert res["s_per_step"] > 0 and np.isfinite(res["first_loss"]) and f"remat={'--remat' in flags}" in res["mode"]
    for flag in ("--xla", "--no-paired"):
        with pytest.raises(SystemExit):
            train_step.main(SMALL + [flag])
        assert "not supported by the PyTorch port" in capsys.readouterr().err


def test_profile_input_measures_the_forward(tmp_path, capsys):
    """profile_input at 64x96: the script's lines, the forward measured (not
    a fixed number), and one JSON line."""
    res = profile_input.main(["--device", "cpu", "--res", "64", "96", "--numdepth", "16", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "per-sample __getitem__ (5 views)" in out and "forward at this res on cpu (measured" in out
    res = res["profile_input"]
    assert SMOKE.BENCH_PROFILE_KEYS <= set(res)
    for k in ("per_sample_ms", "decode_ms", "decode_prep_ms", "forward_ms", "host_over_device", "npy_read_ms"):
        assert np.isfinite(res[k]) and res[k] > 0, k


def test_headline_rig_forward_matches_jax():
    """The headline's rig and images at 64x96 and 16 planes through the JAX
    MVSNet and through the port's, fed the JAX variables by the JAX
    package's export_torch_state_dict, in f32: depth within 1e-3 x the
    depth range, confidence atol 1e-4 (PERF.md section 2)."""
    projs, dv = headline.headline_rig(64, 96, 16)
    imgs = np.random.RandomState(0).rand(1, headline.V, 64, 96, 3).astype(np.float32)
    args = (imgs, projs[None], dv[None])
    jmodel = jmodels.MVSNet()
    jvars = jax.device_get(jmodel.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args)))
    ref = jmodel.apply(jvars, *(jnp.asarray(a) for a in args), train=False)
    port = MVSNet()
    port.load_state_dict({k.removeprefix("module."): torch.from_numpy(np.array(v))
                          for k, v in export_torch_state_dict(jvars).items()}, strict=True)
    with torch.inference_mode():
        out = port.eval()(*(torch.from_numpy(a) for a in args))
    depth_err = np.abs(out["depth"].numpy() - np.asarray(ref["depth"])).max()
    assert depth_err < 1e-3 * float(np.ptp(dv)), depth_err
    np.testing.assert_allclose(out["photometric_confidence"].numpy(), np.asarray(ref["photometric_confidence"]),
                               atol=1e-4)


def test_e2e_eval_parses_every_field(tmp_path, capsys):
    """e2e_eval's bin (two processes) and serve (10 requests to one
    process) on 64x96 trees with 16 planes, eval_cli in processes of its
    own: every field the JAX script reads from eval.py's output is found in
    eval_cli's (none null), and the device-busy share is in (0, 100]."""
    res = e2e_eval.main(SMALL + ["--configs", "bin", "serve", "--out", str(tmp_path)])
    for row in (res["bin_4cam_e2e"], res["bin_4cam_e2e"]["warm_process"]):
        assert E2E_RUN_KEYS <= set(row)
        assert all(row[k] is not None for k in E2E_RUN_KEYS), row
        assert 0 < row["device_busy_pct"] <= 100 and row["views"] == 4
        assert {"loader_wait", "launch", "device_wait", "writer_drain"} <= {
            kv.partition("=")[0] for kv in row["stage_a_phases"].split()}
    serve = res["bin_serve_10scan"]
    assert SERVE_KEYS <= set(serve) and all(serve[k] is not None for k in SERVE_KEYS)
    assert serve["scans"] == 10 and serve["views"] == 40
    assert res["platform"] == "cpu" and _last_json(capsys) == json.loads(json.dumps(res))
    assert not any(p.name.startswith("e2e_eval_") for p in tmp_path.iterdir())  # the work directory is removed


def test_train_e2e_parses_every_field(tmp_path):
    """train_e2e for 1 epoch on a 4-view tree (28 samples) at 64x96 with 16
    planes, train_cli and the step-alone probe in processes of their own:
    every field of the JAX script's row is there and none is null."""
    res = train_e2e.main(SMALL + ["--views", "4", "--epochs", "1", "--out", str(tmp_path)])["train_e2e"]
    assert TRAIN_E2E_KEYS <= set(res) and all(res[k] is not None for k in TRAIN_E2E_KEYS - ON_A_CARD), res
    assert res["steady_epoch"]["samples"] == 28 and res["steady_s_per_step"] > 0 and res["device_s_per_step"] > 0


def test_save_depth_reports_device_busy(tmp_path, capsys):
    """save_depth's stats carry device_busy_frac in (0, 1] (on the CPU the
    forward spans come from the host clock), and its printed line parses
    with scripts/bench_e2e_eval.py's regex to the same share."""
    root = tmp_path / "acq"
    make_eval_tree(str(root), rig=SyntheticRig(n_views=3, img_hw=(32, 32), baseline=3.0), ndepths=8)
    write_scan_list(str(root / "test.txt"), ["scan1"])
    model = random_init_(MVSNet(), torch.Generator().manual_seed(0))
    stats = save_depth(model, dataset="dataloader_eval", dataset_name="bds8", testpath=str(root),
                       testlist=str(root / "test.txt"), outdir=str(tmp_path / "out"), NviewGen=3, numdepth=8,
                       interval_scale=1.0, cam_subfolder="Cameras", img_subfolder="Rectified/{}/rect_C{:0>3}_L00.png",
                       img_res=(32, 32), num_workers=0, device="cpu")
    assert 0 < stats["device_busy_frac"] <= 1
    m = re.search(BUSY_RE, capsys.readouterr().out)
    assert m and float(m.group(1)) == pytest.approx(100 * stats["device_busy_frac"], abs=0.05)


def test_headline_without_a_card_exits_nonzero():
    """python -m ...bench with no card and no --device cpu exits nonzero
    and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    proc = subprocess.run([sys.executable, "-m", "scene_3dreconstruction_mvsnet_tpu_torch.bench", "--hw", "64", "96"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout
    assert "does not fall back to the CPU" in proc.stderr


def test_child_processes_log_their_launches(tmp_path):
    """A process started with MVSNET_TORCH_LAUNCH_LOG appends its kernel
    launch counts to that file at exit, and read_launch_log sums the lines:
    how chip_smoke.py sees the kernels the benches' CLIs launch."""
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels

    log = tmp_path / "launches.jsonl"
    assert kernels.read_launch_log(log) == dict.fromkeys(kernels.KERNEL_NAMES, 0)
    child = ("from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import softmax_regression as k2, "
             "sweep_variance as k1\n"
             "k1.LAUNCHES, k1.EMIT_LAUNCHES, k2.LAUNCHES = {}, 2, {}\n")
    env = dict(os.environ, **{kernels.LAUNCH_LOG_ENV: str(log)})
    for k1, k2 in ((5, 1), (2, 4)):
        subprocess.run([sys.executable, "-c", child.format(k1, k2)], cwd=REPO, env=env, check=True, timeout=120)
    total = kernels.read_launch_log(log)
    assert total == dict(dict.fromkeys(kernels.KERNEL_NAMES, 0), sweep_variance=3, sweep_variance_emit=4,
                         softmax_regression=5)
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_NAMES, 0)
