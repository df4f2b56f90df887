"""chip_smoke.py's own scene generation against the JAX package's, and its
refusal to run without a card. The script imports nothing of the JAX package,
so its ring rig and its eval acquisition are written out there; these tests
hold them to ``bench.py::ring_projs`` and ``data/synthetic.py``'s
``RingRig`` / ``make_eval_tree`` (tolerance 0: the same bytes)."""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from scene_3dreconstruction_mvsnet_tpu.data.synthetic import RingRig, make_eval_tree, make_legacy_dtu_eval_tree

REPO = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke")


def test_headline_rig_matches_bench(smoke):
    """The headline requests' projections equal bench.py's ring_projs, and the
    ring's extrinsics RingRig's."""
    ring_projs = _load("bench").ring_projs
    K = np.array([[smoke.W * 1.1, 0, smoke.W / 2], [0, smoke.W * 1.1, smoke.H / 2], [0, 0, 1]], np.float32)
    for ref in smoke.REF_CAMERAS:
        views = [ref % 49, (ref + 1) % 49, (ref - 1) % 49, (ref + 2) % 49, (ref - 2) % 49]
        projs, dv = smoke.headline_rig(ref)
        np.testing.assert_array_equal(projs, ring_projs(49, views, 150.0, -700.0, 700.0, K / 4.0))
        np.testing.assert_array_equal(dv, np.linspace(425, 905, 192, dtype=np.float32))
    rig = RingRig(n_views=16)
    for v in range(16):
        np.testing.assert_array_equal(smoke.ring_extrinsics(v, 16), rig.extrinsics(v))


def test_ring_scene_writes_make_eval_tree(smoke, tmp_path):
    """RingScene.write_tree writes the files make_eval_tree writes for a
    RingRig: the pair and cam files byte for byte, the same image pixels."""
    smoke.RingScene(6, 64, 96).write_tree(str(tmp_path / "ours"), ["scan1", "scan2"], 16)
    make_eval_tree(str(tmp_path / "jax"), scan="scan1", rig=RingRig(n_views=6, img_hw=(64, 96)), ndepths=16)
    files = ["pair.txt"] + [f"Cameras/{v:0>8}_cam.txt" for v in range(6)]
    for f in files:
        assert (tmp_path / "ours" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    for v in range(6):
        want = np.asarray(Image.open(tmp_path / "jax" / f"Rectified/scan1/rect_C{v:0>3}_L00.png"))
        assert want.std() > 0
        for scan in ("scan1", "scan2"):
            got = np.asarray(Image.open(tmp_path / "ours" / f"Rectified/{scan}/rect_C{v:0>3}_L00.png"))
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """Without a CUDA device, or away from the repository, the script exits
    with a code other than 0 and prints no result line."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert ("torch.cuda.is_available() is False" if where == "checkout" else "checkout") in proc.stdout + proc.stderr


def test_bound_helpers_count_the_work(smoke):
    """The smoke's bound_ms inputs on a small rig: ``sweep_grid`` is the grid
    the plain warp samples with (grid_sample on it reproduces the warp
    exactly), its tap count is a direct count of the bilinear taps inside the
    image, and ``bound`` takes the larger of the bytes' and the operations'
    times."""
    import torch
    import torch.nn.functional as F

    from scene_3dreconstruction_mvsnet_tpu_torch.ops import warp_src_feature

    projs, dv = smoke.headline_rig(12)
    h, w, d = 9, 12, 5
    proj = torch.from_numpy(projs)
    proj[:, :2] /= 24.0  # the ring's cameras at a 9 x 12 feature map
    depth = torch.from_numpy(dv[::40].copy())
    src = torch.rand((h, w, 8), generator=torch.Generator().manual_seed(0))
    grid, taps = smoke.sweep_grid(proj[3], proj[0], depth, h, w)
    want = warp_src_feature(src[None], proj[None, 3], proj[None, 0], depth[None])[0]
    got = F.grid_sample(src.permute(2, 0, 1)[None], grid, align_corners=False)[0].reshape(8, d, h, w)
    torch.testing.assert_close(got.permute(1, 2, 3, 0), want, rtol=0, atol=0)
    ix = ((grid[..., 0].double() + 1) * w - 1) / 2
    iy = ((grid[..., 1].double() + 1) * h - 1) / 2
    count = 0
    for x, y in zip(ix.flatten().tolist(), iy.flatten().tolist()):
        x0, y0 = np.floor(x), np.floor(y)
        count += sum(0 <= x0 + dx < w and 0 <= y0 + dy < h for dx in (0, 1) for dy in (0, 1))
    assert 0 < taps == count < 4 * d * h * w  # some footprints leave the image
    flops = smoke.sweep_flops(proj[:3], depth, h, w, 8)
    taps2 = smoke.sweep_grid(proj[1], proj[0], depth, h, w)[1] + smoke.sweep_grid(proj[2], proj[0], depth, h, w)[1]
    assert flops == 8 * (2 * taps2 + (3 * 2 + 5) * d * h * w)
    b = smoke.bound(3.35e9, 67e9, "f32")
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 1.0) < 1e-12
    assert smoke.bound(3.35e9, 67e12, "f32")["bound_by"] == "operations"


def test_ring_scene_writes_make_legacy_dtu_eval_tree(smoke, tmp_path):
    """RingScene.write_legacy_tree writes the files make_legacy_dtu_eval_tree
    writes for a RingRig at 1200x1600: the pair and cam files byte for byte,
    the same image pixels."""
    smoke.RingScene(3, 1200, 1600).write_legacy_tree(str(tmp_path / "ours"), "scan1", 192)
    make_legacy_dtu_eval_tree(str(tmp_path / "jax"), scan="scan1", rig=RingRig(n_views=3, img_hw=(1200, 1600)),
                              ndepths=192)
    for f in ["Cameras/pair.txt"] + [f"Cameras/{v:0>8}_cam.txt" for v in range(3)]:
        assert (tmp_path / "ours" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    for v in range(3):
        name = f"Rectified_raw/scan1/rect_{v + 1:0>3}_3_r5000.png"
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        assert want.shape == (1200, 1600, 3) and want.std() > 0
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ours" / name)), want)
