"""The port imports, serves, trains and runs both CLIs with JAX,
flax, the JAX package itself and the root's bench scripts unavailable, as
on the machine with the card. No module of the port reaches into the JAX
package, ``interop`` included: the weight bridge carries its own numpy-only
conversion, and the datasets the CLIs read are written by the port's own
``data/synthetic.py``."""

import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["scene_3dreconstruction_mvsnet_tpu"] = None  # the JAX package: every import of it fails
sys.modules["bench"] = None  # and the root's bench scripts, which measure the JAX package
sys.modules["scripts"] = None
import torch
torch.set_num_threads(1)
import scene_3dreconstruction_mvsnet_tpu_torch as pkg
from scene_3dreconstruction_mvsnet_tpu_torch.data.synthetic import (
    SyntheticRig, make_dtu_tree, make_eval_tree, write_scan_list,
)

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "scene_3dreconstruction_mvsnet_tpu_torch.interop.from_jax" in sys.modules

from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_

gen = torch.Generator().manual_seed(0)
model = random_init_(MVSNet(), gen)
imgs = torch.randint(0, 256, (1, 3, 32, 32, 3), generator=gen, dtype=torch.uint8)
eye = torch.eye(4)
projs = torch.stack([eye, eye, eye]).clone()
projs[:, :3, :3] = torch.tensor([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]])
projs[1, 0, 3], projs[2, 1, 3] = 8.0 * 0.5, 8.0 * -0.5
dv = torch.linspace(40.0, 60.0, 8)[None]
out = make_infer_step(model, "cpu")(imgs, projs[None], dv)
assert out["depth"].shape == (1, 8, 8) and out["photometric_confidence"].shape == (1, 8, 8)
assert torch.isfinite(out["depth"]).all() and torch.isfinite(out["photometric_confidence"]).all()
assert ((out["depth"] >= 40.0 - 1e-3) & (out["depth"] <= 60.0 + 1e-3)).all()

# R-MVSNet's recurrence over the 8 planes, K1 in chunks, on the same request
from scene_3dreconstruction_mvsnet_tpu_torch.models import RMVSNet
assert "scene_3dreconstruction_mvsnet_tpu_torch.models.rmvsnet" in sys.modules
rmvs = make_infer_step(random_init_(RMVSNet(), gen), "cpu")(imgs, projs[None], dv)
assert rmvs["depth"].shape == (1, 8, 8) and torch.isin(rmvs["depth"], dv[0]).all()
assert ((rmvs["photometric_confidence"] > 1 / 8) & (rmvs["photometric_confidence"] <= 1)).all()

# the sweep split's code path at one rank (its halos zeros, its gather the identity)
from scene_3dreconstruction_mvsnet_tpu_torch.parallel import VolumeSharding
split = MVSNet(volume_sharding=VolumeSharding(None, 1, 0))
split.load_state_dict(model.state_dict())
out1 = make_infer_step(split, "cpu")(imgs, projs[None], dv)
assert torch.allclose(out1["depth"], out["depth"], rtol=0, atol=1e-4)

from scene_3dreconstruction_mvsnet_tpu_torch.train import make_optimizer, make_scheduler, make_train_step
opt = make_optimizer(model, 1e-3)
step = make_train_step(model, opt, make_scheduler(opt, "1:2", 1), "cpu")
batch = {"imgs": imgs.repeat(2, 1, 1, 1, 1), "proj_matrices": projs[None].repeat(2, 1, 1, 1),
         "depth_values": dv.repeat(2, 1), "depth": torch.full((2, 8, 8), 50.0), "mask": torch.ones(2, 8, 8)}
aux = step(batch)
assert model.training and torch.isfinite(aux["loss"]) and opt.param_groups[0]["lr"] == 5e-4
assert all(p.grad is not None for p in model.parameters())

# the training CLI for one epoch on the DTU tree the test made
from scene_3dreconstruction_mvsnet_tpu_torch import train_cli
root = sys.argv[1]
dtu = root + "/dtu"
make_dtu_tree(dtu, rig=SyntheticRig(n_views=3, img_hw=(32, 32), baseline=4.0), ndepths=8)
write_scan_list(dtu + "/list.txt", ["scan1"])
train_cli.main(["--mode", "train", "--dataset", "dtu_yao", "--trainpath", dtu, "--trainlist", dtu + "/list.txt",
                "--testlist", dtu + "/list.txt", "--epochs", "1", "--batch_size", "7", "--numdepth", "8",
                "--NtrainViews", "3", "--NtestViews", "3", "--logdir", root + "/log", "--num_workers", "0",
                "--seed", "1", "--device", "cpu"])
assert os.path.exists(root + "/log/model_000000.ckpt")

# both eval stages, the fused conv0 and the warp dumps, on the eval tree the test made
from scene_3dreconstruction_mvsnet_tpu_torch import eval_cli
acq = root + "/acq"
make_eval_tree(acq, rig=SyntheticRig(n_views=3, img_hw=(32, 32), baseline=3.0), ndepths=8)
write_scan_list(acq + "/test.txt", ["scan1"])
out = eval_cli.main([
    "--dataset", "dataloader_eval", "--dataset_name", "bds8", "--testpath", acq, "--testlist", acq + "/test.txt",
    "--loadckpt", root + "/model.ckpt", "--outdir", root + "/out", "--NviewGen", "3", "--NviewFilter", "2",
    "--numdepth", "8", "--interval_scale", "1.0", "--photomask", "0.0", "--geomask", "1", "--save_ply",
    "--num_workers", "0", "--img_res", "32", "32", "--cam_subfolder", "Cameras",
    "--img_subfolder", "Rectified/{}/rect_C{:0>3}_L00.png", "--dtype", "bfloat16", "--pallas_conv0",
    "--debug_MVSnet", "2", "--device", "cpu",
])
assert out["stage_a"]["n_views"] == 3 and os.path.exists(root + "/out/acq/mvsnet001_l3.ply")
assert {"scene_3dreconstruction_mvsnet_tpu_torch.train_cli", "scene_3dreconstruction_mvsnet_tpu_torch.train.loop",
        "scene_3dreconstruction_mvsnet_tpu_torch.data.pipeline", "scene_3dreconstruction_mvsnet_tpu_torch.io.images",
        "scene_3dreconstruction_mvsnet_tpu_torch.ops.paired_sweep",
        "scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.warp_grad",
        "scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.paired_grad",
        "scene_3dreconstruction_mvsnet_tpu_torch.eval_cli", "scene_3dreconstruction_mvsnet_tpu_torch.eval.depth_gen",
        "scene_3dreconstruction_mvsnet_tpu_torch.eval.filtering", "scene_3dreconstruction_mvsnet_tpu_torch.eval.fusion",
        "scene_3dreconstruction_mvsnet_tpu_torch.eval.scene_kit", "scene_3dreconstruction_mvsnet_tpu_torch.utils.debug_dump",
        "scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.conv0_fused",
        "scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.plane_sweep_warp",
        "scene_3dreconstruction_mvsnet_tpu_torch.parallel.mesh",
        "scene_3dreconstruction_mvsnet_tpu_torch.parallel.collectives",
        "scene_3dreconstruction_mvsnet_tpu_torch.parallel.sharding",
        "scene_3dreconstruction_mvsnet_tpu_torch.parallel.halo",
        "scene_3dreconstruction_mvsnet_tpu_torch.data.synthetic",
        "scene_3dreconstruction_mvsnet_tpu_torch.recipes"} <= set(sys.modules)
from scene_3dreconstruction_mvsnet_tpu_torch import recipes
assert recipes.preset_argv("train_BlenderDS")[:2] == ["--mode=train", "--dataset=blender"]
print("imported", len(names), "modules")
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    """Every module of the port imports with the JAX package blocked; one
    request is served (also by R-MVSNet, and through the sweep split's path
    at one rank), one
    training step taken, a DTU tree and an eval tree written by the port's
    synthetic module, one epoch trained by train_cli and the 3-view scan
    evaluated by eval_cli, on the CPU."""
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_

    model = random_init_(MVSNet(), torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, tmp_path / "model.ckpt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path)], cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "imported" in proc.stdout
