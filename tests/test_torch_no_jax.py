"""The port imports, serves and trains with JAX and flax unavailable, as on
the machine with the card."""

import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
torch.set_num_threads(1)
import scene_3dreconstruction_mvsnet_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)

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

from scene_3dreconstruction_mvsnet_tpu_torch.train import make_optimizer, make_scheduler, make_train_step
opt = make_optimizer(model, 1e-3)
step = make_train_step(model, opt, make_scheduler(opt, "1:2", 1), "cpu")
batch = {"imgs": imgs.repeat(2, 1, 1, 1, 1), "proj_matrices": projs[None].repeat(2, 1, 1, 1),
         "depth_values": dv.repeat(2, 1), "depth": torch.full((2, 8, 8), 50.0), "mask": torch.ones(2, 8, 8)}
aux = step(batch)
assert model.training and torch.isfinite(aux["loss"]) and opt.param_groups[0]["lr"] == 5e-4
assert all(p.grad is not None for p in model.parameters())
shared = sorted(m for m in sys.modules if m.startswith("scene_3dreconstruction_mvsnet_tpu."))
assert shared == [
    "scene_3dreconstruction_mvsnet_tpu.data",  # the numpy-only loader the Trainer reuses
    "scene_3dreconstruction_mvsnet_tpu.data.pipeline",
    "scene_3dreconstruction_mvsnet_tpu.interop",
    "scene_3dreconstruction_mvsnet_tpu.interop.torch_import",
], shared
assert {"scene_3dreconstruction_mvsnet_tpu_torch.train_cli", "scene_3dreconstruction_mvsnet_tpu_torch.train.loop",
        "scene_3dreconstruction_mvsnet_tpu_torch.ops.paired_sweep",
        "scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.warp_grad"} <= set(names)
print("imported", len(names), "modules")
"""


def test_port_imports_and_runs_without_jax():
    """Every module of the port imports; one request is served and one
    training step taken, on the CPU."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout
