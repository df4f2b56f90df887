"""The port's legacy DTU CLI (``evaldtu_cli``) against the repository's
``evalDTU.py`` on the CPU: ``auto_depth_chunk``, stage B (``filter_depth``)
on identical fabricated stage-A files, and stage A (``save_depth``) against
the JAX package's ``make_infer_step`` on the same sample.

Stage B compares floats with thresholds, so it is held to the criteria of
tests/test_torch_eval.py: photo masks equal; geo and final masks equal but
at pixels within 1e-3 px or 1e-6 of a threshold, at most 0.1 % of the
pixels; colours equal and points at rtol 1e-5 where both final masks hold
(points away from a threshold). The source depth is sampled with a zero
border, so a reprojection within 1e-3 px of a source map's edge rows or
columns mixes in a zero tap by a weight that the last bits of its
coordinate set; such points, like those on a threshold, may differ by more
(2e-5 measured) and are left out of the point comparison."""

import argparse
import importlib.util
import os
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu.data import find_dataset_def as j_find_dataset_def
from scene_3dreconstruction_mvsnet_tpu.data.synthetic import SyntheticRig, make_legacy_dtu_eval_tree, write_scan_list
from scene_3dreconstruction_mvsnet_tpu.eval import filtering as jfilt
from scene_3dreconstruction_mvsnet_tpu.eval.depth_gen import auto_depth_chunk as j_auto_depth_chunk
from scene_3dreconstruction_mvsnet_tpu.interop import import_torch_state_dict
from scene_3dreconstruction_mvsnet_tpu.io.cams import read_camera_parameters, write_pair_file
from scene_3dreconstruction_mvsnet_tpu.io.images import read_img
from scene_3dreconstruction_mvsnet_tpu.io.pfm import read_pfm, save_pfm
from scene_3dreconstruction_mvsnet_tpu.io.ply import read_ply
from scene_3dreconstruction_mvsnet_tpu.models import MVSNet as JaxMVSNet
from scene_3dreconstruction_mvsnet_tpu.train.state import make_infer_step as j_make_infer_step
from scene_3dreconstruction_mvsnet_tpu_torch import evaldtu_cli
from scene_3dreconstruction_mvsnet_tpu_torch.eval.depth_gen import auto_depth_chunk
from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
from tests.test_torch_eval import PIXEL_BAND, _assert_masks_agree, _near_threshold

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
H_D, W_D = 296, 400  # stage A's output size at 1184x1600
THRESHOLDS = dict(photomask=0.8, geomask=2, condmask_pixel=1.0, condmask_depth=0.01)


def _evaldtu():
    """The repository's evalDTU.py, loaded by path."""
    spec = importlib.util.spec_from_file_location("repo_evalDTU", REPO / "evalDTU.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("img_res,numdepth,budget,batch", [
    ((1200, 1600), 192, 100_000_000, 1), ((1200, 1600), 8, 100_000_000, 1), ((864, 1152), 192, 100_000_000, 1),
    ((864, 1152), 192, 100_000_000, 4), ((512, 640), 192, 1_000_000, 1), ((512, 640), 7, 10_000_000, 2),
])
def test_auto_depth_chunk_matches_jax(img_res, numdepth, budget, batch):
    assert auto_depth_chunk(img_res, numdepth, budget, batch) == j_auto_depth_chunk(img_res, numdepth, budget, batch)
    assert auto_depth_chunk((1200, 1600), 192) == 24  # evalDTU.py's chunk at D = 192


@pytest.fixture(scope="module")
def legacy_tree(tmp_path_factory):
    """make_legacy_dtu_eval_tree's 3-view rig at 1200x1600, and its stage-A
    files fabricated: the analytic depths at 296x400 with 0.4 %
    multiplicative noise (relative depth differences straddle the 1 %
    threshold) and uniform random confidences (the photo mask splits)."""
    root = tmp_path_factory.mktemp("legacy") / "dtu"
    rig = SyntheticRig(n_views=3, img_hw=(1200, 1600), z0=500.0, slope_x=0.1, baseline=25.0, focal=1100.0)
    make_legacy_dtu_eval_tree(str(root), scan="scan9", rig=rig, ndepths=8)
    write_scan_list(str(root / "list.txt"), ["scan9"])
    rng = np.random.RandomState(0)
    depths = np.stack([rig.depth_map(v, scale=4)[:H_D, :W_D] * (1 + 0.004 * rng.randn(H_D, W_D))
                       for v in range(3)]).astype(np.float32)
    cams = [read_camera_parameters(str(root / "Cameras" / f"{v:0>8}_cam.txt")) for v in range(3)]
    Ks = np.stack([K for K, _ in cams])
    Ks[:, :2] /= 4.0
    return {"root": root, "rig": rig, "depths": depths, "confs": rng.rand(3, H_D, W_D).astype(np.float32),
            "Ks": Ks, "Es": np.stack([E for _, E in cams])}


def _read_mask(path):
    return read_img(str(path)) > 0.5


def _on_source_edge(s, ref, srcs):
    """Pixels of reference view ``ref`` whose reprojection into any of
    ``srcs`` lies within PIXEL_BAND of that map's first or last row or
    column, by JAX's own reproject_with_depth."""
    d = s["depths"]
    H, W = d.shape[1:]
    edge = np.zeros((H, W), bool)
    for src in srcs:
        *_, x_src, y_src = (np.asarray(a) for a in jfilt.reproject_with_depth(*(jnp.asarray(a) for a in (
            d[ref], s["Ks"][ref], s["Es"][ref], d[src], s["Ks"][src], s["Es"][src]))))
        for c, n in ((x_src, W), (y_src, H)):
            edge |= (np.abs(c) < PIXEL_BAND) | (np.abs(c - (n - 1)) < PIXEL_BAND)
    return edge


def test_filter_depth_matches_evaldtu(legacy_tree, tmp_path):
    """Both packages' filter_depth(args, ...) with the same Namespace on the
    same files: masks, PLY rows matched to their pixels, colours and
    points."""
    s = legacy_tree
    args = argparse.Namespace(NviewFilter=2, pairfile="pair.txt", device="cpu", **THRESHOLDS)
    runs = {}
    for name, fn in (("jax", _evaldtu().filter_depth), ("port", evaldtu_cli.filter_depth)):
        out = tmp_path / name / "dtu" / "scan9"
        for kind, maps in (("depth_est", s["depths"]), ("confidence", s["confs"])):
            os.makedirs(out / kind)
            for v in range(3):
                save_pfm(str(out / kind / f"{v:0>8}.pfm"), maps[v])
        ply = tmp_path / name / "dtu" / "mvsnet009_l3.ply"
        fn(args, str(s["root"]), "scan9", str(out), str(ply))
        runs[name] = (out, read_ply(str(ply)))
    (pts_p, cols_p), (pts_j, cols_j) = runs["port"][1], runs["jax"][1]
    pair = [(0, [1, 2]), (1, [0, 2]), (2, [1, 0])]  # the rig's pair file
    flips, rows, matched = 0, {"port": 0, "jax": 0}, 0
    for ref, srcs in pair:
        near = _near_threshold(s, ref, srcs, THRESHOLDS["condmask_pixel"], THRESHOLDS["condmask_depth"])
        masks = {name: {kind: _read_mask(runs[name][0] / "mask" / f"{ref:0>8}_{kind}.png")
                        for kind in ("photo", "geo", "final")} for name in runs}
        np.testing.assert_array_equal(masks["port"]["photo"], masks["jax"]["photo"])
        for kind in ("geo", "final"):
            _assert_masks_agree(masks["port"][kind], masks["jax"][kind], near, f"{kind} {ref}")
        assert 0.05 < masks["jax"]["final"].mean() < 0.95  # the masks split
        flips += int((masks["port"]["final"] != masks["jax"]["final"]).sum())
        per_pixel = {}
        for name, (pts, cols) in (("port", (pts_p, cols_p)), ("jax", (pts_j, cols_j))):
            final = masks[name]["final"].reshape(-1)
            n = int(final.sum())
            p, c = np.full((final.size, 3), np.nan, np.float32), np.zeros((final.size, 3), np.uint8)
            p[final], c[final] = pts[rows[name]:rows[name] + n], cols[rows[name]:rows[name] + n]
            rows[name] += n
            per_pixel[name] = (p, c)
        both = (masks["port"]["final"] & masks["jax"]["final"]).reshape(-1)
        matched += int(both.sum())
        np.testing.assert_array_equal(per_pixel["port"][1][both], per_pixel["jax"][1][both])
        far = both & ~(near | _on_source_edge(s, ref, srcs)).reshape(-1)
        np.testing.assert_allclose(per_pixel["port"][0][far], per_pixel["jax"][0][far], rtol=1e-5,
                                   atol=1e-5 * np.abs(pts_j).max())
    assert rows == {"port": pts_p.shape[0], "jax": pts_j.shape[0]}  # every vertex is a final pixel
    assert matched > 0 and abs(pts_p.shape[0] - pts_j.shape[0]) <= flips


def test_evaldtu_cli_matches_jax_infer_step(legacy_tree, tmp_path):
    """evaldtu_cli end to end on the CPU at --numdepth 8 --NviewGen 2:
    every PFM, mask and the PLY are written, and view 0's depth and
    confidence PFMs agree with the JAX package's make_infer_step on the same
    sample (the JAX package's dtu_yao_eval) within 1e-3 x the depth range
    and 1e-4 (the model parity bounds, tests/test_models_parity.py)."""
    root = tmp_path / "dtu"
    shutil.copytree(legacy_tree["root"], root)
    write_pair_file(str(root / "Cameras" / "pair.txt"), [(0, [1]), (1, [0])])  # two views keep the CPU run short
    model = random_init_(MVSNet(), torch.Generator().manual_seed(0))
    state = {"module." + k: v for k, v in model.state_dict().items()}
    torch.save({"model": state}, tmp_path / "model.ckpt")
    out_dir = tmp_path / "out"
    out = evaldtu_cli.main(["--testpath", str(root), "--testlist", str(root / "list.txt"), "--loadckpt",
                            str(tmp_path / "model.ckpt"), "--outdir", str(out_dir), "--numdepth", "8",
                            "--NviewGen", "2", "--NviewFilter", "1", "--num_workers", "0", "--photomask", "0",
                            "--geomask", "1", "--condmask_pixel", "6", "--condmask_depth", "0.5", "--device", "cpu"])
    assert out["stage_a"]["n_views"] == 2 and out["stage_b"][0]["points"] > 0
    scan = out_dir / "dtu" / "scan9"
    for v in range(2):
        for f in (f"depth_est/{v:0>8}.pfm", f"confidence/{v:0>8}.pfm",
                  *(f"mask/{v:0>8}_{k}.png" for k in ("photo", "geo", "final"))):
            assert (scan / f).exists(), f
    assert (out_dir / "dtu" / "mvsnet009_l3.ply").exists()
    assert sorted(os.listdir(scan)) == ["confidence", "depth_est", "mask"]  # PFMs only, no cams or images

    dataset = j_find_dataset_def("dtu_yao_eval")(str(root), str(root / "list.txt"), "test", 2, ndepths=8,
                                                 interval_scale=1.06)
    sample = dataset[0]
    variables = import_torch_state_dict({k: v.numpy() for k, v in state.items() if "num_batches" not in k})
    jmodel = JaxMVSNet(refine=False, depth_chunk=j_auto_depth_chunk((1200, 1600), 8))
    ref = j_make_infer_step(jmodel)(variables, *(jnp.asarray(sample[k][None])
                                               for k in ("imgs", "proj_matrices", "depth_values")))
    dv = sample["depth_values"]
    want = np.asarray(ref["depth"])[0]
    assert want.shape == (H_D, W_D) and want.std() > 1e-3 * np.ptp(dv)  # the depth map is not flat
    depth, _ = read_pfm(str(scan / "depth_est" / "00000000.pfm"))
    conf, _ = read_pfm(str(scan / "confidence" / "00000000.pfm"))
    assert np.abs(depth - want).max() < 1e-3 * np.ptp(dv)
    np.testing.assert_allclose(conf, np.asarray(ref["photometric_confidence"])[0], atol=1e-4)


@pytest.mark.parametrize("ckpt", ["missing", "directory"])
def test_evaldtu_cli_refuses_what_it_cannot_load(legacy_tree, tmp_path, ckpt):
    """No --loadckpt, or an orbax directory, stops the CLI with
    eval_cli.load_weights's message before stage A."""
    root = legacy_tree["root"]
    argv = ["--testpath", str(root), "--testlist", str(root / "list.txt"), "--outdir", str(tmp_path), "--device",
            "cpu"]
    if ckpt == "directory":
        argv += ["--loadckpt", str(tmp_path)]
    with pytest.raises(SystemExit, match="is a directory" if ckpt == "directory" else "--loadckpt is required"):
        evaldtu_cli.main(argv)
    assert not (tmp_path / "dtu").exists()
