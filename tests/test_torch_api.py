"""The JAX package's public API on the port: every public name of the JAX
package is held to its counterpart in the port or to a stated reason (read
from the JAX sources with ``ast``, without importing them), and these names
are held against their JAX functions on the CPU: the rigid
inverse and the projection, ``read_mask``, the depth metrics, the pose
helpers, ``geometric_filter_stack``, ``BasicBlock`` and ``Hourglass3d``
(weights carried across by ``export_block_state_dict``), the transposed
conv without its ReLU, the misc utilities, ``find_model_def`` and the
argument table the three CLIs print."""

import argparse
import ast
import importlib
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu import models as jmodels
from scene_3dreconstruction_mvsnet_tpu import utils as jutils
from scene_3dreconstruction_mvsnet_tpu.eval import filtering as jfilt
from scene_3dreconstruction_mvsnet_tpu.eval import scene_kit as jkit
from scene_3dreconstruction_mvsnet_tpu.geometry import transforms as jgeo
from scene_3dreconstruction_mvsnet_tpu.io import images as jimages
from scene_3dreconstruction_mvsnet_tpu.train import metrics as jmetrics
from scene_3dreconstruction_mvsnet_tpu_torch import eval_cli, evaldtu_cli, train_cli
from scene_3dreconstruction_mvsnet_tpu_torch import models as tmodels
from scene_3dreconstruction_mvsnet_tpu_torch import utils as tutils
from scene_3dreconstruction_mvsnet_tpu_torch.data.synthetic import SyntheticRig, make_eval_tree
from scene_3dreconstruction_mvsnet_tpu_torch.eval import filtering as tfilt
from scene_3dreconstruction_mvsnet_tpu_torch.eval import scene_kit as tkit
from scene_3dreconstruction_mvsnet_tpu_torch.geometry import transforms as tgeo
from scene_3dreconstruction_mvsnet_tpu_torch.interop import export_block_state_dict
from scene_3dreconstruction_mvsnet_tpu_torch.interop.from_jax import _put_deconv_bn
from scene_3dreconstruction_mvsnet_tpu_torch.io import images as timages
from scene_3dreconstruction_mvsnet_tpu_torch.train import metrics as tmetrics
from tests.test_torch_eval import THRESHOLDS, _assert_masks_agree, _near_threshold, filter_scene  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "scene_3dreconstruction_mvsnet_tpu"
PORT = "scene_3dreconstruction_mvsnet_tpu_torch"

# JAX module path -> the port's, where the file was renamed
MODULE_MAP = {"ops/pallas/": "ops/kernels/", "interop/torch_import.py": "interop/from_jax.py"}

_PLANNER = ("the TPU kernels' window planner: Mosaic's gather reaches within 128 lanes, a GPU thread loads from "
            "any address (ROADMAP 'Don't port')")
_TPU_LAYOUT = ("TPU layout (flat and decomposed convs); the port runs cuDNN's convs and the transposed conv by "
               "output parity (models/blocks.py), and ROADMAP Queue 2 brings the flat layouts back only if an H100 "
               "measurement asks for them")

# "<JAX module path>::<name>" (or a whole module's path) -> the port's counterpart as "<port module>:<name>",
# which must exist, or a one-line reason it has none
COUNTERPARTS = {
    # another name in the port
    "train/lr.py::multistep_lr": "train.lr:make_scheduler",
    "train/__init__.py::multistep_lr": "train.lr:make_scheduler",
    "train/state.py::TrainState": "nn.Module plus torch.optim: the port's model and optimizer hold the state",
    "train/__init__.py::TrainState": "nn.Module plus torch.optim: the port's model and optimizer hold the state",
    "train/state.py::make_infer_step": "infer:make_infer_step",
    "train/__init__.py::make_infer_step": "infer:make_infer_step",
    "train/__init__.py::Trainer": "train.loop:Trainer",
    "train/__init__.py::SummaryLogger": "train.logging:SummaryLogger",
    "ops/paired_sweep.py::make_paired_cost_volume": "ops.paired_sweep:PairedCostVolume",
    "interop/torch_import.py::import_torch_state_dict": "train.checkpoint:load_model",
    "interop/torch_import.py::load_torch_checkpoint": "train.checkpoint:load_model",
    "interop/__init__.py::import_torch_state_dict": "train.checkpoint:load_model",
    "interop/__init__.py::load_torch_checkpoint": "train.checkpoint:load_model",
    "parallel/sharding.py::replicate": "parallel.collectives:broadcast_module",
    "parallel/__init__.py::replicate": "parallel.collectives:broadcast_module",
    "parallel/sharding.py::batch_sharding": "parallel.sharding:shard_rows",
    "parallel/__init__.py::batch_sharding": "parallel.sharding:shard_rows",
    "parallel/sharding.py::shard_batch": "parallel.sharding:shard_rows",
    "parallel/__init__.py::shard_batch": "parallel.sharding:shard_rows",
    "parallel/sharding.py::volume_partition_spec": "parallel.sharding:VolumeSharding",
    "ops/pallas/sweep_variance.py::sweep_variance_pallas": "ops.kernels.sweep_variance:sweep_variance",
    "ops/pallas/softmax_regression.py::fused_softmax_regression": "ops.kernels.softmax_regression:softmax_regression",
    "ops/pallas/warp_grad.py::warp_grad_pallas": "ops.kernels.warp_grad:warp_grad",
    "ops/pallas/warp_grad.py::make_warp_with_pallas_grad": "ops.paired_sweep:PairedCostVolume",
    "ops/pallas/conv0_fused.py::conv0_bn_relu_fused": "ops.kernels.conv0_fused:conv0_bn_relu",
    "ops/pallas/conv0_fused.py::conv0_band_weights": "ops.kernels.conv0_fused:mma_weight_fragments",
    "ops/pallas/plane_sweep_warp.py::warp_src_feature_pallas": "ops.kernels.plane_sweep_warp:plane_sweep_warp",
    # only because of the TPU or JAX
    "train/checkpoint.py::restore_variables": "reads orbax, which the card's machine lacks; eval_cli names the "
                                              "conversion to a .ckpt",
    "train/__init__.py::restore_variables": "reads orbax, which the card's machine lacks; eval_cli names the "
                                            "conversion to a .ckpt",
    "train/state.py::make_infer_step_views": "serves the TPU's device image store (ROADMAP 'Don't port')",
    "train/__init__.py::make_infer_step_views": "serves the TPU's device image store (ROADMAP 'Don't port')",
    "ops/paired_sweep.py::suggest_family_envelopes": _PLANNER,
    "ops/pallas/sweep_variance.py::SweepPlan": _PLANNER,
    "ops/pallas/sweep_variance.py::plan_sweep": _PLANNER,
    "ops/pallas/sweep_variance.py::plan_is_valid": _PLANNER,
    "ops/pallas/sweep_variance.py::suggest_envelope": _PLANNER,
    "ops/pallas/sweep_variance.py::merge_envelopes": _PLANNER,
    "ops/pallas/sweep_variance.py::pack_features": "packs features into the TPU kernel's lane layout; K1 reads "
                                                   "[V, H, W, C]",
    "ops/pallas/warp_grad.py::GradPlan": _PLANNER,
    "ops/pallas/warp_grad.py::plan_grad": _PLANNER,
    "ops/pallas/warp_grad.py::suggest_grad_envelope": _PLANNER,
    "ops/pallas/plane_sweep_warp.py::WindowPlan": _PLANNER,
    "ops/pallas/plane_sweep_warp.py::plan_windows": _PLANNER,
    "ops/pallas/plane_sweep_warp.py::suggest_envelope": _PLANNER,
    "ops/pallas/conv0_fused.py::pack_flat_wide": _TPU_LAYOUT,
    "models/blocks.py::DecomposedConv3d": _TPU_LAYOUT,
    "models/blocks.py::FlatConvBnReLU": _TPU_LAYOUT,
    "models/blocks.py::FlatConvBnReLU3D": _TPU_LAYOUT,
    "models/blocks.py::FlatConvTransposeBnReLU3D": _TPU_LAYOUT,
    "models/blocks.py::FlatDecomposedConv3d": _TPU_LAYOUT,
    "models/blocks.py::conv3d_k3_decomposed": _TPU_LAYOUT,
    "models/blocks.py::conv3d_transpose_k3s2_decomposed": _TPU_LAYOUT,
    "models/cost_reg_net.py::FusedFlatConv0": _TPU_LAYOUT,
    "ops/flat_conv.py": "the flat block-Toeplitz conv layout exists for the TPU's tiles (ROADMAP 'Don't port')",
    "utils/aot_cache.py": "the XLA executable cache (ROADMAP 'Don't port')",
}

# JAX public names the port carries under their own name: each at its JAX module path, exported as JAX exports it
PORTED = {
    "models/blocks.py": ["BasicBlock", "Hourglass3d"],
    "models/__init__.py": ["BasicBlock", "Hourglass3d", "find_model_def"],
    "eval/filtering.py": ["geometric_filter_stack"],
    "eval/scene_kit.py": ["invert_pose", "camera_poses", "to_open3d"],
    "eval/__init__.py": ["geometric_filter_stack", "camera_poses"],
    "geometry/transforms.py": ["invert_rigid", "project_points"],
    "geometry/__init__.py": ["invert_rigid", "project_points"],
    "io/images.py": ["read_mask"],
    "io/__init__.py": ["read_mask"],
    "train/metrics.py": ["abs_depth_error", "threshold_error_rate"],
    "train/__init__.py": ["abs_depth_error", "threshold_error_rate"],
    "utils/misc.py": ["print_args", "make_recursive_func", "to_numpy", "to_float", "DictAverageMeter"],
    "utils/__init__.py": ["print_args", "make_recursive_func", "to_numpy", "to_float", "DictAverageMeter"],
}


def jax_public_names(path: Path) -> set[str]:
    """A JAX module's public top-level defs and classes; for a package's
    ``__init__`` also every name it imports and every entry of ``__all__``."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
        if path.name == "__init__.py":
            if isinstance(node, ast.ImportFrom):
                names |= {a.asname or a.name for a in node.names}
            if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
                names |= {e.value for e in node.value.elts}
    return names


def port_module_name(rel: str) -> str:
    for jax_path, port_path in MODULE_MAP.items():
        if rel.startswith(jax_path):
            rel = port_path + rel[len(jax_path):]
    parts = rel.removesuffix(".py").split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([PORT, *parts])


def resolve(ref: str):
    """``"<port module>:<name>"`` -> the object, or None where it is missing."""
    module, name = ref.split(":")
    return getattr(importlib.import_module(f"{PORT}.{module}"), name, None)


def test_every_jax_public_name_has_a_counterpart():
    """Each public name of each JAX module exists in the port's module at the
    same path (``ops/pallas`` -> ``ops/kernels``, ``interop/torch_import`` ->
    ``interop/from_jax``), or stands in COUNTERPARTS with the port's name,
    which must exist, or a one-line reason. No entry is stale: each names a
    JAX name that exists and that the port's module lacks."""
    missing, stale, used = [], [], set()
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        names = jax_public_names(path)
        try:
            module = importlib.import_module(port_module_name(rel))
        except ModuleNotFoundError:
            if rel in COUNTERPARTS:
                used.add(rel)
            elif names:
                missing.append(f"{rel} (no port module)")
            continue
        for name in sorted(names):
            key = f"{rel}::{name}"
            if key in COUNTERPARTS:
                used.add(key)
                if hasattr(module, name):
                    stale.append(f"{key} exists in the port")
            elif not hasattr(module, name):
                missing.append(key)
    assert not missing, f"JAX public names with no counterpart in the port: {missing}"
    assert not stale and not set(COUNTERPARTS) - used, (stale, sorted(set(COUNTERPARTS) - used))
    for key, value in COUNTERPARTS.items():
        assert value and "\n" not in value, key
        if re.fullmatch(r"[\w.]+:\w+", value):
            assert resolve(value) is not None, f"{key} -> {value} is missing"


@pytest.mark.parametrize("rel", sorted(PORTED))
def test_ported_names_sit_at_the_jax_path(rel):
    """The names in PORTED are at their JAX module's path in the port, and
    each package exports them as its JAX ``__init__`` does."""
    module = importlib.import_module(port_module_name(rel))
    assert set(PORTED[rel]) <= jax_public_names(JAX_PKG / rel)
    for name in PORTED[rel]:
        assert hasattr(module, name), name
        if rel.endswith("__init__.py"):
            assert name in module.__all__, name


# -- geometry -------------------------------------------------------------------

def _rigid(rng, n: int) -> np.ndarray:
    """n random rigid-body [4, 4] matrices (a rotation from QR, a translation
    of ~500 mm)."""
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        q, r = np.linalg.qr(rng.randn(3, 3))
        out[i, :3, :3] = q * np.sign(np.diag(r))
        out[i, :3, 3] = 500.0 * rng.randn(3)
        out[i, 3, 3] = 1.0
    return out


@pytest.mark.parametrize("batch", [(), (3,), (2, 3)], ids=["single", "batch3", "batch2x3"])
def test_invert_rigid_matches_jax(batch):
    """(R^T | -R^T t) over leading dims: within 1e-6 x max|E^-1| of JAX's, and
    E^-1 E = I."""
    rng = np.random.RandomState(1)
    E = _rigid(rng, int(np.prod(batch, dtype=int))).reshape(*batch, 4, 4)
    want = np.asarray(jgeo.invert_rigid(jnp.asarray(E)))
    got = tgeo.invert_rigid(torch.from_numpy(E)).numpy()
    assert got.shape == E.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), E.shape)
    np.testing.assert_allclose(got @ E, eye, rtol=0, atol=1e-6 * np.abs(E).max())


def test_project_points_matches_jax():
    """Homogeneous world points [4, N] -> pixel xy [2, N] and camera depth
    [N]: within 1e-6 x max|x| of JAX's."""
    rng = np.random.RandomState(2)
    E = _rigid(rng, 1)[0]
    K = np.array([[800.0, 0, 320], [0, 800.0, 256], [0, 0, 1]], np.float32)
    cam = np.stack([rng.uniform(-200, 200, 64), rng.uniform(-200, 200, 64), rng.uniform(400, 900, 64)])
    world = np.linalg.inv(E.astype(np.float64)) @ np.vstack([cam, np.ones(64)])
    pts = world.astype(np.float32)
    want_xy, want_z = (np.asarray(a) for a in jgeo.project_points(jnp.asarray(pts), jnp.asarray(K), jnp.asarray(E)))
    got_xy, got_z = (a.numpy() for a in tgeo.project_points(torch.from_numpy(pts), torch.from_numpy(K),
                                                           torch.from_numpy(E)))
    assert got_xy.shape == (2, 64) and got_z.shape == (64,)
    np.testing.assert_allclose(got_xy, want_xy, rtol=0, atol=1e-6 * np.abs(want_xy).max())
    np.testing.assert_allclose(got_z, want_z, rtol=0, atol=1e-6 * np.abs(want_z).max())


# -- io, metrics, poses ---------------------------------------------------------

def test_read_mask_matches_jax(tmp_path):
    """A rendered PNG of data/synthetic.py's eval tree, thresholded at 0.5:
    equal to JAX's read_mask."""
    make_eval_tree(str(tmp_path), rig=SyntheticRig(n_views=2, img_hw=(32, 48)), ndepths=8)
    png = str(tmp_path / "Rectified/scan1/rect_C000_L00.png")
    want = jimages.read_mask(png)
    got = timages.read_mask(png)
    assert got.dtype == np.bool_ and got.any() and not got.all()
    np.testing.assert_array_equal(got, want)


def _depth_batch():
    rng = np.random.RandomState(3)
    gt = rng.uniform(400, 900, (3, 16, 20)).astype(np.float32)
    est = (gt + rng.standard_t(2, gt.shape) * 3).astype(np.float32)
    mask = (rng.rand(*gt.shape) > 0.3).astype(np.float32)
    mask[2] = 0.0  # an image with no valid pixel
    return est, gt, mask


def test_abs_depth_error_matches_jax():
    est, gt, mask = _depth_batch()
    want = float(jmetrics.abs_depth_error(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask) > 0.5))
    got = float(tmetrics.abs_depth_error(torch.from_numpy(est), torch.from_numpy(gt), torch.from_numpy(mask) > 0.5))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("thres", [1.0, 2.0, 4.0, 8.0])
def test_threshold_error_rate_matches_jax(thres):
    est, gt, mask = _depth_batch()
    want = float(jmetrics.threshold_error_rate(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask) > 0.5, thres))
    got = float(tmetrics.threshold_error_rate(torch.from_numpy(est), torch.from_numpy(gt),
                                              torch.from_numpy(mask) > 0.5, thres))
    assert 0.0 < want < 1.0 and abs(got - want) <= 1e-6


def _depth_metrics_before(depth_est, depth_gt, mask):
    """depth_metrics as it was before abs_depth_error and
    threshold_error_rate were split out (one process, no group)."""
    valid = mask > 0.5
    err = (depth_est - depth_gt).abs()
    per_image = [tmetrics._masked_per_image_mean(err, valid)]
    per_image += [tmetrics._masked_per_image_mean((err > t).float(), valid) for t in (1, 2, 4, 8)]
    return dict(zip(["abs_depth_error"] + [f"thres{t}mm_error" for t in (1, 2, 4, 8)], [m.mean() for m in per_image]))


def test_depth_metrics_unchanged_bit_for_bit():
    """depth_metrics on the public functions gives the bits it gave before,
    and JAX's values within 1e-6."""
    est, gt, mask = (torch.from_numpy(a) for a in _depth_batch())
    got = tmetrics.depth_metrics(est, gt, mask)
    want = _depth_metrics_before(est, gt, mask)
    jwant = jmetrics.depth_metrics(*(jnp.asarray(a.numpy()) for a in (est, gt, mask)))
    assert list(got) == list(want) == list(jwant)
    for k in got:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
        assert abs(float(got[k]) - float(jwant[k])) <= 1e-6 * max(1.0, abs(float(jwant[k]))), k


def test_invert_pose_and_camera_poses_match_jax():
    """f64: the camera->world pose and each camera's centre and axis within
    1e-12 of JAX's; the first camera highlighted."""
    Es = list(_rigid(np.random.RandomState(4), 5).astype(np.float64))
    for E in Es:
        for got, want in zip(tkit.invert_pose(E[:3, :3], E[:3, 3]), jkit.invert_pose(E[:3, :3], E[:3, 3])):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    got, want = tkit.camera_poses(Es), jkit.camera_poses(Es)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["highlight"] == w["highlight"]
        for k in ("center", "direction"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12)
    assert [c["highlight"] for c in got] == [True, False, False, False, False]


def test_to_open3d_raises_without_open3d(monkeypatch):
    """open3d is imported only by the call, which raises ImportError where
    the package is absent."""
    monkeypatch.setitem(sys.modules, "open3d", None)
    with pytest.raises(ImportError):
        tkit.to_open3d(np.zeros((4, 3), np.float32))


# -- the consistency filter over all source views -------------------------------

@pytest.mark.parametrize("ref,srcs", [(0, [1, 2, 3, 4]), (3, [2, 4, 1])])
def test_geometric_filter_stack_matches_jax(filter_scene, ref, srcs):
    """One batched call over the source views against JAX's vmapped one:
    per-view masks and the mask count equal off 1e-3 px / 1e-6 of a
    threshold, the reprojected-depth sum within rtol 1e-5 away from them;
    the count equal to fuse_reference_view's geo_mask_sum."""
    s = filter_scene
    cp, cd = THRESHOLDS["condmask_pixel"], THRESHOLDS["condmask_depth"]
    args = [s[k][ref] for k in ("depths", "Ks", "Es")] + [s[k][srcs] for k in ("depths", "Ks", "Es")]
    wsum, wdep, wmasks = (np.asarray(a) for a in jfilt.geometric_filter_stack(
        *(jnp.asarray(a) for a in args), condmask_pixel=cp, condmask_depth=cd))
    gsum, gdep, gmasks = tfilt.geometric_filter_stack(*(torch.from_numpy(a) for a in args), condmask_pixel=cp,
                                                      condmask_depth=cd)
    assert gsum.dtype == torch.int32 and gmasks.dtype == torch.bool
    assert gmasks.shape == (len(srcs), 32, 48) and gsum.shape == gdep.shape == (32, 48)
    near = _near_threshold(s, ref, srcs, cp, cd)
    for i, src in enumerate(srcs):
        assert wmasks[i].any() and not wmasks[i].all()
        _assert_masks_agree(gmasks[i].numpy(), wmasks[i], _near_threshold(s, ref, [src], cp, cd), f"{ref}->{src}")
    _assert_masks_agree(gsum.numpy(), wsum, near, "geo_mask_sum")
    np.testing.assert_allclose(gdep.numpy()[~near], wdep[~near], rtol=1e-5)
    fused = tfilt.fuse_reference_view(s["depths"][ref], s["confs"][ref], s["Ks"][ref], s["Es"][ref],
                                      s["depths"][srcs], s["Ks"][srcs], s["Es"][srcs], device="cpu", **THRESHOLDS)
    np.testing.assert_array_equal(gsum.numpy(), fused["geo_mask_sum"])


# -- the blocks MVSNet does not use ---------------------------------------------

def _randomize(variables, seed: int):
    """Every leaf of flax variables drawn from a seed: kernels ~N(0, 0.3),
    BatchNorm scales and running variances near 1, shifts and running means
    near 0, so a leaf loaded under a wrong key shows."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        n = rng.randn(*leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return 1.0 + 0.2 * np.abs(n) if name == "var" else 1.0 + 0.2 * n
        return 0.3 * n if name == "kernel" else 0.1 * n

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(variables))


def _load_block(block: torch.nn.Module, state: dict) -> torch.nn.Module:
    """``state`` (numpy, no num_batches_tracked) into ``block`` with strict=True."""
    full = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in state.items()}
    full.update({n: torch.zeros_like(b) for n, b in block.named_buffers() if n.endswith("num_batches_tracked")})
    block.load_state_dict(full, strict=True)
    return block


def _close(got: np.ndarray, want: np.ndarray, what: str, rel: float = 1e-4) -> None:
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} > {rel:.0e} x {scale:.3e}"


def _hold_block(jblock, variables, tblock, x_last, mode, stats_of) -> None:
    """Run the JAX block on channels-last ``x_last`` and the port's (loaded
    from the same ``variables``) on it channels-first, in ``mode``: outputs
    within 1e-4 x max|y|, and in train mode each running statistic
    (``stats_of`` pairs the port's buffers with the JAX updates)."""
    train = mode == "train"
    if train:
        y, upd = jblock.apply(variables, jnp.asarray(x_last), train=True, mutable=["batch_stats"])
    else:
        y = jblock.apply(variables, jnp.asarray(x_last), train=False)
    tblock.train(train)
    with torch.no_grad():
        got = np.moveaxis(tblock(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x_last, -1, 1)))).numpy(), 1, -1)
    want = np.asarray(y)
    assert got.shape == want.shape
    _close(got, want, f"{mode} output")
    if train:
        for name, (buf, jstat) in stats_of(tblock, jax.device_get(upd["batch_stats"])).items():
            _close(buf.numpy(), np.asarray(jstat), name)


def _bn_pairs(tblock, jstats, conv_bn: list[str], deconv_bn: list[str] = ()) -> dict:
    pairs = {}
    for blk in conv_bn:
        if blk in jstats:
            bn = tblock.get_submodule(blk).bn
            pairs[f"{blk} mean"] = (bn.running_mean, jstats[blk]["bn"]["mean"])
            pairs[f"{blk} var"] = (bn.running_var, jstats[blk]["bn"]["var"])
    for blk in deconv_bn:
        bn = tblock.get_submodule(blk)[1]
        pairs[f"{blk} mean"] = (bn.running_mean, jstats[blk]["bn"]["mean"])
        pairs[f"{blk} var"] = (bn.running_var, jstats[blk]["bn"]["var"])
    return pairs


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("stride,downsample,cin", [(2, True, 4), (1, False, 8)], ids=["stride2_down", "stride1"])
def test_basic_block_matches_jax(mode, stride, downsample, cin):
    """BasicBlock with the JAX block's variables carried across by
    export_block_state_dict (strict): within 1e-4 x max|y|, and in train
    mode every BatchNorm's running statistics too."""
    x = np.random.RandomState(6).rand(2, 12, 16, cin).astype(np.float32)
    jblock = jmodels.BasicBlock(8, stride, downsample)
    variables = _randomize(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    tblock = _load_block(tmodels.BasicBlock(cin, 8, stride, downsample),
                         export_block_state_dict("BasicBlock", variables))
    assert (tblock.downsample is None) == (not downsample)
    _hold_block(jblock, variables, tblock, x, mode, lambda t, s: _bn_pairs(t, s, ["conv1", "conv2", "downsample"]))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_hourglass3d_matches_jax(mode):
    """Hourglass3d(4) on [1, 4, 8, 8, 8] with the JAX block's variables
    (strict load; the ``dconv*`` kernels flipped back): within 1e-4 x
    max|y|, and in train mode every BatchNorm's running statistics."""
    x = np.random.RandomState(7).randn(1, 8, 8, 8, 4).astype(np.float32)
    jblock = jmodels.Hourglass3d(4)
    variables = _randomize(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    state = export_block_state_dict("Hourglass3d", variables)
    assert {k.split(".")[0] for k in state} == {"conv1a", "conv1b", "conv2a", "conv2b", "dconv2", "dconv1",
                                                "redir1", "redir2"}
    assert "dconv2.0.weight" in state and "dconv1.1.running_var" in state
    tblock = _load_block(tmodels.Hourglass3d(4), state)
    _hold_block(jblock, variables, tblock, x, mode,
                lambda t, s: _bn_pairs(t, s, ["conv1a", "conv1b", "conv2a", "conv2b", "redir1", "redir2"],
                                       ["dconv2", "dconv1"]))


def test_export_block_state_dict_refuses_other_blocks():
    with pytest.raises(KeyError, match="unknown block 'CostRegNet'"):
        export_block_state_dict("CostRegNet", {"params": {}, "batch_stats": {}})


@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_conv_transpose_relu_flag_matches_jax(mode, relu):
    """ConvTransposeBnReLU3D(relu=False) against the JAX block with
    relu=False (and the default against the default): within 1e-4 x
    max|y|, negative outputs kept without the ReLU; in train mode the
    running statistics too."""
    x = np.random.RandomState(8).randn(1, 4, 6, 5, 8).astype(np.float32)
    jblock = jmodels.ConvTransposeBnReLU3D(4, relu=relu)
    variables = _randomize(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    state: dict = {}
    _put_deconv_bn(state, "blk", variables["params"], variables["batch_stats"])
    tblock = _load_block(tmodels.ConvTransposeBnReLU3D(8, 4, relu=relu),
                         {k.removeprefix("blk."): v for k, v in state.items()})
    _hold_block(jblock, variables, tblock, x, mode,
                lambda t, s: {"mean": (t[1].running_mean, s["bn"]["mean"]), "var": (t[1].running_var, s["bn"]["var"])})
    tblock.eval()
    with torch.no_grad():
        y = tblock(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    assert (y.min() < 0) == (not relu)


# -- misc utilities, the model registry, the CLIs' argument table ---------------

def test_print_args_matches_jax(capsys):
    ns = argparse.Namespace(mode="train", lr=1e-3, lrepochs="10,12,14:2", loadckpt=None, img_res=[512, 640],
                            resume=False, batch_size=4)
    jutils.print_args(ns)
    want = capsys.readouterr().out
    tutils.print_args(ns)
    assert capsys.readouterr().out == want
    tutils.print_args({"a": 1})
    jutils.print_args({"a": 1})
    got, want = capsys.readouterr().out.split("#" * 72 + "\n")[:2]
    assert got == want


def test_recursive_mappers_match_jax():
    """to_numpy and to_float over nested dicts/lists/tuples of tensors give
    JAX's results over the same values as numpy; strings and None pass."""
    rng = np.random.RandomState(9)
    arrays = {"depth": rng.rand(2, 3).astype(np.float32), "nested": [rng.rand(4), (rng.rand(1), "tag")], "n": None}
    tensors = {"depth": torch.from_numpy(arrays["depth"]).requires_grad_(),
               "nested": [torch.from_numpy(arrays["nested"][0]), (torch.from_numpy(arrays["nested"][1][0]), "tag")],
               "n": None}
    got, want = tutils.to_numpy(tensors), jutils.to_numpy(arrays)
    assert isinstance(got["nested"][1], tuple) and got["nested"][1][1] == "tag" and got["n"] is None
    for g, w in ((got["depth"], want["depth"]), (got["nested"][0], want["nested"][0]),
                 (got["nested"][1][0], want["nested"][1][0])):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, w)
    scalars = {"loss": torch.tensor(0.25), "m": [np.float32(1.5), 2.0]}
    assert tutils.to_float(scalars) == jutils.to_float({"loss": np.float32(0.25), "m": [np.float32(1.5), 2.0]})
    assert tutils.to_float(scalars) == {"loss": 0.25, "m": [1.5, 2.0]}
    double = tutils.make_recursive_func(lambda v: 2 * v)
    assert double({"a": [1, (2, 3)]}) == jutils.make_recursive_func(lambda v: 2 * v)({"a": [1, (2, 3)]})
    assert tutils.get_powers(6) == jutils.get_powers(6) == ["1", "2"]


def test_dict_average_meter_matches_jax():
    ours, theirs = tutils.DictAverageMeter(), jutils.DictAverageMeter()
    for step in ({"loss": 1.0, "err": 0.5}, {"loss": 3.0, "err": 1.5}, {"loss": 2.0, "err": 1.0}):
        ours.update(step)
        theirs.update(step)
    assert ours.mean() == theirs.mean() == {"loss": 2.0, "err": 1.0}
    with pytest.raises(TypeError, match="expects float values, got loss"):
        ours.update({"loss": torch.tensor(1.0)})
    with pytest.raises(TypeError):
        theirs.update({"loss": 1})


def test_find_model_def():
    """The registry: 'mvsnet' is MVSNet, and the port also has 'casmvsnet'
    and 'rmvsnet' (CasMVSNet and R-MVSNet, inference only, which the JAX
    package lacks); another name raises JAX's KeyError text with the port's
    list of names, also through train_cli's --model, which trains MVSNet
    only."""
    assert tmodels.find_model_def("mvsnet") is tmodels.MVSNet
    assert tmodels.find_model_def("casmvsnet") is tmodels.CasMVSNet
    assert tmodels.find_model_def("rmvsnet") is tmodels.RMVSNet
    with pytest.raises(KeyError) as want:
        jmodels.find_model_def("nomodel")
    with pytest.raises(KeyError) as got:
        tmodels.find_model_def("nomodel")
    assert str(got.value) == str(want.value).replace("['mvsnet']", "['casmvsnet', 'mvsnet', 'rmvsnet']")
    with pytest.raises(KeyError) as cli:
        train_cli.main(["--model", "nomodel", "--device", "cpu"])
    assert str(cli.value) == str(got.value)
    with pytest.raises(NotImplementedError, match="training path"):
        train_cli.main(["--model", "casmvsnet", "--device", "cpu"])


def _load_root(name: str):
    spec = importlib.util.spec_from_file_location(f"_root_{name}", REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(out: str) -> tuple[list, dict]:
    """The ``argv:`` line and the argument table of a CLI's output ->
    (argv, {arg: (value, type)})."""
    lines = out.splitlines()
    start = lines.index("#" * 32 + "  args  " + "#" * 32)
    assert lines[start - 1].startswith("argv: ")
    end = lines.index("#" * 72, start)
    table = {}
    for row in lines[start + 1 : end]:
        k, v, t = (c.strip() for c in row.split("\t"))
        table[k] = (v, t)
    return ast.literal_eval(lines[start - 1][len("argv: "):]), table


def _run_to_failure(main, expect, capsys) -> str:
    with pytest.raises(expect):
        main()
    return capsys.readouterr().out


@pytest.mark.parametrize("cli", ["train", "eval", "evalDTU"])
def test_cli_prints_argv_and_the_args_table_as_jax(cli, tmp_path, monkeypatch, capsys):
    """The port's CLI prints ``argv:`` and then print_args' table, as the
    repository's train.py, eval.py and evalDTU.py do for the same flags:
    the same argv and the same rows (value and type), once the flags that
    only one side has are taken out (--device, the TPU flags). Each run is
    stopped by the first missing input after the print."""
    missing = str(tmp_path / "missing")
    flags = {
        "train": ["--trainpath", missing, "--trainlist", missing + "/list.txt", "--batch_size", "2",
                  "--numdepth", "16", "--lrepochs", "4,8:2", "--dtype", "bfloat16", "--Nlights", "3:7"],
        "eval": ["--testpath", missing, "--testlist", missing + "/test.txt", "--numdepth", "32",
                 "--img_res", "64", "96", "--photomask", "0.3", "--dtype", "bfloat16"],
        "evalDTU": ["--testpath", missing, "--testlist", missing + "/test.txt", "--numdepth", "32",
                    "--NviewGen", "3", "--condmask_depth", "0.02"],
    }[cli]
    port_main, port_parser, expect = {
        "train": (train_cli.main, train_cli.build_parser(), FileNotFoundError),
        "eval": (eval_cli.main, eval_cli.build_parser(), SystemExit),
        "evalDTU": (evaldtu_cli.main, evaldtu_cli.build_parser(), SystemExit),
    }[cli]
    root = _load_root(cli)
    monkeypatch.setattr(sys, "argv", [f"{cli}.py", *flags])
    jax_argv, jax_table = _printed(_run_to_failure(root.main, expect, capsys))
    port_argv, port_table = _printed(_run_to_failure(lambda: port_main(flags + ["--device", "cpu"]), expect, capsys))
    assert jax_argv == flags and port_argv == flags + ["--device", "cpu"]
    one_sided = set(jax_table) ^ set(port_table)
    tpu_flags = {f.lstrip("-") for f in getattr(sys.modules[port_main.__module__], "REFUSED", {})}
    assert "device" in one_sided
    shared = sorted(set(jax_table) - one_sided - tpu_flags)
    assert len(shared) >= 15
    for k in shared:
        assert port_table[k] == jax_table[k], k
    for k in tpu_flags & set(port_table):  # refused by the port: parsed to None, never set
        assert port_table[k][0] == "None", k
    assert set(vars(port_parser.parse_args(flags))) == set(port_table)
