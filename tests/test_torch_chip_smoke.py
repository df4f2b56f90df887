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

from scene_3dreconstruction_mvsnet_tpu.data.synthetic import (
    RingRig,
    SyntheticRig,
    make_eval_tree,
    make_legacy_dtu_eval_tree,
)

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


@pytest.mark.parametrize("stage", [2, 3])
def test_cascade_stage_inputs_are_the_cascades_planes(smoke, stage):
    """The cascade phase's inputs at CasMVSNet's stage 2 and 3 shapes: the
    ring's projections with the intrinsic rows scaled to the stage, and per
    pixel the stage's planes, evenly spaced by (N / (N - 1)) ratio interval
    about a depth inside the sweep; ``near_integer_index`` reads each
    pixel's own planes, and ``sweep_flops`` counts per-pixel planes as the
    same per-plane ones."""
    import torch

    projs, _ = smoke.headline_rig(smoke.REF_CAMERAS[0])
    proj, planes = smoke.cascade_stage_inputs(torch.Generator().manual_seed(stage), stage)
    n, ratio = smoke.CAS_NDEPTHS[stage - 1], smoke.CAS_RATIOS[stage - 1]
    scale = 2 ** (stage - 1)
    h, w = smoke.H // 4 * scale, smoke.W // 4 * scale
    assert tuple(planes.shape) == (1, n, h, w) and planes.dtype == torch.float32 and planes.is_contiguous()
    want = torch.from_numpy(projs)[None].clone()
    want[..., :2, :] *= scale
    torch.testing.assert_close(proj, want, rtol=0, atol=0)
    interval = (smoke.DEPTH_MAX - smoke.DEPTH_MIN) / smoke.D
    step = planes[:, 1:] - planes[:, :-1]
    torch.testing.assert_close(step, torch.full_like(step, ratio * interval * n / (n - 1)), rtol=1e-4, atol=1e-3)
    mid = planes.mean(1)
    assert smoke.DEPTH_MIN < mid.min().item() and mid.max().item() < smoke.DEPTH_MAX
    on_plane = planes[:, 3] + 0 * mid
    between = 0.5 * (planes[:, 3] + planes[:, 4])
    assert smoke.near_integer_index(on_plane, torch.zeros_like(mid), planes).all()
    assert not smoke.near_integer_index(between, torch.zeros_like(mid), planes).any()

    p_small = torch.from_numpy(projs)
    p_small[:, :2] /= 24.0
    depth = torch.linspace(500.0, 800.0, 4)
    per_pixel = depth[:, None, None].expand(4, 9, 12).contiguous()
    assert smoke.sweep_flops(p_small[:3], per_pixel, 9, 12, 8) == smoke.sweep_flops(p_small[:3], depth, 9, 12, 8)


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


def test_bench_kernel_cases_are_the_bench_shapes(smoke, tmp_path):
    """The more shapes at which the recipes phase holds K1 and K2 to their
    plain versions: the views, planes and feature sizes of the four
    configurations of scripts/bench_configs.py, and the bin tree's rig at
    batch 2, its depth values those its camera files give (the JAX
    package's SyntheticRig.write_cam_file for the same rig)."""
    cases = {name: (samples, dv, h, w) for name, samples, dv, h, w in smoke.kernel_shape_cases()}
    got = {name: (len(s), s[0].shape[0], dv.shape[1], h, w) for name, (s, dv, h, w) in cases.items()}
    assert got == {"dtu_small_3v_96d_512x640": (1, 3, 96, 128, 160),
                   "dtu_full_5v_192d_864x1152": (1, 5, 192, 216, 288),
                   "bds8_49cam_5v_192d_512x640": (1, 5, 192, 128, 160),
                   "bin_4cam_4v_192d_512x640": (1, 4, 192, 128, 160),
                   "bin tree, batch 2": (2, 4, 192, 128, 160)}
    samples, dv, _, _ = cases["bin tree, batch 2"]
    rig = SyntheticRig(n_views=4, img_hw=(512, 640), baseline=2.0, z0=500.0, slope_x=0.15, focal=512.0)
    rig.write_cam_file(str(tmp_path / "cam.txt"), 0, 192)
    depth_min, interval = map(float, (tmp_path / "cam.txt").read_text().split()[-2:])
    np.testing.assert_allclose(dv[:, [0, 1]], [[depth_min, depth_min + interval]] * 2, rtol=1e-6)
    assert all(p.dtype == np.float32 and np.isfinite(p).all() for s, *_ in cases.values() for p in s)
    # the two rings are scripts/bench_configs.py's, byte for byte
    ring_rig = _load("scripts/bench_configs").ring_rig
    K = np.array([[640 * 1.1, 0, 320], [0, 640 * 1.1, 256], [0, 0, 1]], np.float32) / 4.0
    assert cases["bds8_49cam_5v_192d_512x640"][0][0].tobytes() == \
        ring_rig(49, 150.0, -700.0, 700.0, K)[[0, 1, 48, 2, 47]].tobytes()
    assert cases["bin_4cam_4v_192d_512x640"][0][0].tobytes() == ring_rig(4, 120.0, -650.0, 650.0, K).tobytes()


@pytest.mark.parametrize("name,n_cams,hw,views,pairfile", [
    ("bds8", 49, (48, 60), (30, 34, 46, 47), "eval_pair_4x4_30-34-46-47.txt"),
    ("bin", 4, (48, 60), None, "pair.txt"),
    ("dtu", 11, (60, 80), None, "pair.txt"),
])
def test_ring_scene_writes_the_registry_layouts(smoke, tmp_path, name, n_cams, hw, views, pairfile):
    """The recipes phase's eval trees: RingScene.write_registry_tree writes
    the files that the CPU tests' registry_tree writes from the JAX
    package's RingRig for the bds8, bin and DTU registries (the same names,
    the pair and cam files byte for byte, the same image pixels), at the
    same --testpath."""
    from tests.test_torch_io import registry_tree

    scan = "scan1"
    ours = smoke.RingScene(n_cams, *hw).write_registry_tree(str(tmp_path / "ours"), name, scan, 192, views, pairfile)
    theirs = registry_tree(tmp_path / "jax", name, RingRig(n_views=n_cams, img_hw=hw), scan, 192, views=views,
                           pairfile=pairfile)
    assert Path(ours).relative_to(tmp_path / "ours") == theirs.relative_to(tmp_path / "jax")
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "ours") for p in (tmp_path / "ours").rglob("*") if p.is_file())
    assert len(files) == 1 + 2 * len(views or range(n_cams))
    for f in files:
        if f.suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ours" / f)),
                                          np.asarray(Image.open(tmp_path / "jax" / f)))
        else:
            assert (tmp_path / "ours" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_dtu_registry_tree_loads_at_the_registrys_size(smoke, tmp_path):
    """eval_DTU's tree as the recipes phase writes it (1200x1600 images, 1-based
    names, the pair file at the root) loads through dataloader_eval with the
    dtu registry and no overrides: rescaled to 600x800, then cropped to
    576x800 (a multiple of 32; 144x200 features), the sample the JAX
    package's dataloader_eval gives (tolerance 0)."""
    from scene_3dreconstruction_mvsnet_tpu import data as jdata
    from scene_3dreconstruction_mvsnet_tpu_torch import data as tdata
    from scene_3dreconstruction_mvsnet_tpu_torch.eval_cli import DICT_CAM_SUBFOLDER, DICT_IMG_RES, DICT_IMG_SUBFOLDER

    root = smoke.RingScene(3, 1200, 1600).write_registry_tree(str(tmp_path), "dtu", "scan1", 192)
    (tmp_path / "test.txt").write_text("scan1\n")
    args = (root, str(tmp_path / "test.txt"), "test", 3, 192, 1.06)
    kw = {"cam_subfolder": DICT_CAM_SUBFOLDER["dtu"], "img_subfolder": DICT_IMG_SUBFOLDER["dtu"],
          "img_res": DICT_IMG_RES["dtu"], "dataset_name": "dtu", "emit_u8": True}
    ours, theirs = tdata.find_dataset_def("dataloader_eval")(*args, **kw), jdata.find_dataset_def("dataloader_eval")(
        *args, **kw)
    assert len(ours) == len(theirs) == 3
    got, want = ours[2], theirs[2]
    assert got["imgs"].shape == (3, 576, 800, 3) and got["imgs"].dtype == np.uint8 and got["imgs"].std() > 0
    for k, v in got.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        else:
            assert v == want[k], k


def test_recipe_kernel_shapes_are_the_presets(smoke):
    """The shapes at which the recipes phase holds K1 and K2 (and, at the
    train_BlenderDS step's, K1-emit, K3-terms and K3) to their plain
    versions: (B, V, D, feature height, width, dtype) of each preset."""
    assert smoke.recipe_kernel_shapes() == {
        "train_BlenderDS step": (3, 5, 192, 128, 160, "bfloat16"),
        "train_BlenderDS test pass": (3, 5, 192, 128, 160, "bfloat16"),
        "eval_BlenderDS": (1, 4, 192, 128, 160, "float32"),
        "eval_binpicking": (1, 4, 192, 128, 160, "float32"),
        "eval_DTU": (1, 5, 192, 144, 200, "float32"),
        "eval_DTU --dtype bfloat16": (1, 5, 192, 144, 200, "bfloat16"),
    }
    assert set(smoke.RECIPE_EVAL_TREES) == {"eval_BlenderDS", "eval_binpicking", "eval_DTU"}
    bds8 = smoke.RECIPE_EVAL_TREES["eval_BlenderDS"]
    assert bds8[0] == "bds8" and bds8[1] == 49 and bds8[3] == (30, 34, 46, 47)
    assert smoke.RECIPE_EVAL_TREES["eval_DTU"][1] >= 11  # NviewFilter 10 sources and the reference


def test_batchnorm_shapes_are_the_cells_volumes(smoke):
    """The BatchNorm phase's volumes are the cells' full-resolution 8-channel
    CostRegNet volumes: dtu_request's and dtu_train's at a quarter of the
    image with every plane, casmvs_dtu_request's stage 3 at the full image
    with its last stage's planes."""
    import json

    mvs = json.loads((REPO / "mvsbench/configs/mvsnet_dtu.json").read_text())
    cas = json.loads((REPO / "mvsbench/configs/casmvsnet_dtu.json").read_text())
    ev, tr = mvs["eval"], mvs["train"]
    want = {(1, 8, ev["numdepth"], ev["img_hw"][0] // 4, ev["img_hw"][1] // 4),
            (cas["eval"]["batch"], cas["cr_base_chs"][2], cas["ndepths"][2], *cas["eval"]["img_hw"]),
            (tr["batch"], 8, tr["numdepth"], tr["img_hw"][0] // 4, tr["img_hw"][1] // 4)}
    assert set(smoke.BN_SHAPES) == want


def test_without_bn_drops_only_the_batchnorm_kernels(smoke):
    """The other phases' launch checks see every kernel but the BatchNorm
    kernels, and no zero count."""
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import KERNEL_NAMES

    counts = dict.fromkeys(KERNEL_NAMES, 2)
    kept = smoke.without_bn(counts)
    assert set(kept) == set(KERNEL_NAMES) - set(smoke.BN_KERNELS) and set(smoke.BN_KERNELS) <= set(KERNEL_NAMES)
    assert smoke.without_bn(dict(counts, sweep_variance=0)).keys() == kept.keys() - {"sweep_variance"}


def test_prob_shapes_are_the_cells_inputs(smoke):
    """The prob phase's inputs are the cells' prob inputs: dtu_request's and
    dtu_train's 8 channels at a quarter of the image with every plane and
    MVSNet's bias, and casmvs_dtu_request's three stages (the image at 1/4,
    1/2 and 1/1 with the stages' planes) without one."""
    import json

    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import KERNEL_NAMES

    mvs = json.loads((REPO / "mvsbench/configs/mvsnet_dtu.json").read_text())
    cas = json.loads((REPO / "mvsbench/configs/casmvsnet_dtu.json").read_text())
    ev, tr, hw = mvs["eval"], mvs["train"], cas["eval"]["img_hw"]
    want = {((1, 8, ev["numdepth"], ev["img_hw"][0] // 4, ev["img_hw"][1] // 4), True),
            ((tr["batch"], 8, tr["numdepth"], tr["img_hw"][0] // 4, tr["img_hw"][1] // 4), True)}
    want |= {((cas["eval"]["batch"], cas["cr_base_chs"][s], cas["ndepths"][s], hw[0] >> (2 - s), hw[1] >> (2 - s)),
              False) for s in range(3)}
    assert set(smoke.PROB_SHAPES) == want and set(smoke.PROB_KERNELS) <= set(KERNEL_NAMES)
