"""The port's own file formats, datasets and loader against the JAX
package's: the same bytes written, the same arrays read, the same samples
and the same batches in the same order. The port's eval and training read
and write through these, so they must agree exactly (tolerance 0)."""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from scene_3dreconstruction_mvsnet_tpu import data as jdata
from scene_3dreconstruction_mvsnet_tpu.data import synthetic
from scene_3dreconstruction_mvsnet_tpu.io import cams as jcams
from scene_3dreconstruction_mvsnet_tpu.io import images as jimages
from scene_3dreconstruction_mvsnet_tpu.io import pfm as jpfm
from scene_3dreconstruction_mvsnet_tpu.io import ply as jply
from scene_3dreconstruction_mvsnet_tpu.utils.misc import get_powers as j_get_powers
from scene_3dreconstruction_mvsnet_tpu_torch import data as tdata
from scene_3dreconstruction_mvsnet_tpu_torch import io as tio
from scene_3dreconstruction_mvsnet_tpu_torch.eval_cli import DICT_CAM_SUBFOLDER, DICT_IMG_RES, DICT_IMG_SUBFOLDER
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import bf16_ulps
from scene_3dreconstruction_mvsnet_tpu_torch.utils.misc import get_powers

torch.set_num_threads(1)


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


# -- codecs -------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 11), (7, 11, 1), (5, 4, 3)])
def test_pfm_matches_jax(tmp_path, shape):
    img = np.random.RandomState(0).randn(*shape).astype(np.float32)
    tio.save_pfm(str(tmp_path / "t.pfm"), img, scale=2.0)
    jpfm.save_pfm(str(tmp_path / "j.pfm"), img, scale=2.0)
    _same_file(tmp_path / "t.pfm", tmp_path / "j.pfm")
    got, got_scale = tio.read_pfm(str(tmp_path / "j.pfm"))
    want, want_scale = jpfm.read_pfm(str(tmp_path / "j.pfm"))
    assert got.dtype == np.float32 and got_scale == want_scale == 2.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(img.shape), img)
    with pytest.raises(ValueError):
        tio.save_pfm(str(tmp_path / "x.pfm"), img.astype(np.float64))


def test_cam_and_pair_files_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    K, E = rng.rand(3, 3).astype(np.float32) * 500, rng.randn(4, 4).astype(np.float32)
    tio.write_cam(str(tmp_path / "t_cam.txt"), K, E, ["425.0", "2.5", "192", "933.0"])
    jcams.write_cam(str(tmp_path / "j_cam.txt"), K, E, ["425.0", "2.5", "192", "933.0"])
    _same_file(tmp_path / "t_cam.txt", tmp_path / "j_cam.txt")
    for scale in (1.0, 1.06):
        got, want = tio.read_cam_file(str(tmp_path / "j_cam.txt"), scale), jcams.read_cam_file(
            str(tmp_path / "j_cam.txt"), scale)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(tio.read_camera_parameters(str(tmp_path / "j_cam.txt")),
                    jcams.read_camera_parameters(str(tmp_path / "j_cam.txt"))):
        np.testing.assert_array_equal(g, w)
    pairs = [(0, [1, 2, 3]), (1, [0]), (2, [3, 1, 0]), (3, [])]
    tio.write_pair_file(str(tmp_path / "t_pair.txt"), pairs)
    jcams.write_pair_file(str(tmp_path / "j_pair.txt"), pairs)
    _same_file(tmp_path / "t_pair.txt", tmp_path / "j_pair.txt")
    assert tio.read_pair_file(str(tmp_path / "j_pair.txt")) == jcams.read_pair_file(str(tmp_path / "j_pair.txt"))


@pytest.mark.parametrize("colors", ["u8", "float", None])
def test_ply_matches_jax(tmp_path, colors):
    rng = np.random.RandomState(2)
    pts = rng.randn(57, 3) * 100
    cols = {"u8": rng.randint(0, 256, (57, 3)).astype(np.uint8), "float": rng.uniform(-20, 300, (57, 3)),
            None: None}[colors]
    tio.write_ply(str(tmp_path / "t.ply"), pts, cols)
    jply.write_ply(str(tmp_path / "j.ply"), pts, cols)
    _same_file(tmp_path / "t.ply", tmp_path / "j.ply")
    for g, w in zip(tio.read_ply(str(tmp_path / "j.ply")), jply.read_ply(str(tmp_path / "j.ply"))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_images_and_masks_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    mask = rng.rand(9, 13) > 0.5
    tio.save_mask(str(tmp_path / "t_mask.png"), mask)
    jimages.save_mask(str(tmp_path / "j_mask.png"), mask)
    _same_file(tmp_path / "t_mask.png", tmp_path / "j_mask.png")
    with pytest.raises(ValueError):
        tio.save_mask(str(tmp_path / "x.png"), mask.astype(np.uint8))
    for name, img in (("f32", rng.uniform(-0.2, 1.2, (9, 13, 3)).astype(np.float32)),
                      ("u8", rng.randint(0, 256, (9, 13, 3)).astype(np.uint8)),
                      ("grey", rng.rand(9, 13).astype(np.float32))):
        tio.save_image_u8(str(tmp_path / f"t_{name}.png"), img)
        jimages.save_image_u8(str(tmp_path / f"j_{name}.png"), img)
        _same_file(tmp_path / f"t_{name}.png", tmp_path / f"j_{name}.png")
        np.testing.assert_array_equal(tio.read_img(str(tmp_path / f"j_{name}.png")),
                                      jimages.read_img(str(tmp_path / f"j_{name}.png")))
        for hw in ((5, 7), (12, 20)):
            np.testing.assert_array_equal(tio.resize_img(img, hw), jimages.resize_img(img, hw))


@pytest.mark.parametrize("src_hw,target", [((100, 130), (64, 96)), ((96, 128), (64, 64)), ((70, 90), (70, 90))])
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_read_rescale_crop_img_matches_jax(tmp_path, src_hw, target, mode):
    """Rescale to cover the target, centre-crop (to the target, or down to
    a multiple of 32), the intrinsics adjusted in place; grey stacked to 3
    channels; u8 and float output; upscaling refused."""
    rng = np.random.RandomState(4)
    shape = src_hw + ((3,) if mode == "RGB" else ())
    path = str(tmp_path / "img.png")
    Image.fromarray(rng.randint(0, 256, shape).astype(np.uint8), mode).save(path)
    K = np.array([[120.0, 0, 60.0], [0, 118.0, 47.0], [0, 0, 1]], np.float32)
    for u8 in (True, False):
        k_t, k_j = K.copy(), K.copy()
        got, k_got = tio.read_rescale_crop_img(path, k_t, target, return_u8=u8)
        want, k_want = jimages.read_rescale_crop_img(path, k_j, target, return_u8=u8)
        assert got.dtype == want.dtype and got.shape == want.shape and got.shape[-1] == 3
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(k_got, k_want)
        assert k_got is k_t  # adjusted in place, as the reference's
    with pytest.raises(ValueError):
        tio.read_rescale_crop_img(path, K.copy(), (src_hw[0] + 1, src_hw[1]))


def test_small_helpers():
    """The debug-bitmask decoder against JAX's, and the bf16 ulp count the
    kernels are held to: an error of 2^-7 |v| is one ulp, the floor lifts
    the magnitude near 0."""
    for n in range(70):
        assert get_powers(n) == j_get_powers(n)
    ref = torch.tensor([1.0, -2.0, 0.0, 4.0])
    assert bf16_ulps(ref, ref) == 0.0
    assert bf16_ulps(ref + torch.tensor([2.0 ** -7, 0, 0, 0]), ref) == pytest.approx(1.0, rel=1e-2)
    assert bf16_ulps(ref + torch.tensor([0, 0, 1e-3, 0]), ref, floor=1.0) == pytest.approx(0.128, rel=1e-2)


# -- datasets and the loader ---------------------------------------------------------

BDS8_PAIRFILE, BDS8_VIEWS = "eval_pair_4x4_30-34-46-47.txt", (30, 34, 46, 47)  # the eval_BlenderDS preset's


def registry_tree(root, dataset_name, rig, scan, ndepths, views=None, pairfile="pair.txt"):
    """make_eval_tree's files for ``views`` of ``rig`` (default all; the cam
    files' depth range is the whole rig's) in the layout of eval.py's
    registry for ``dataset_name``: the camera folder and image names of
    DICT_CAM_SUBFOLDER and DICT_IMG_SUBFOLDER (DTU's images count from 1),
    the pair file ``pairfile`` at the tree's root, or two directories above
    it for the bin. The pair file keeps each reference view's sources among
    ``views`` in the rig's order. Returns the tree's root (the CLI's
    --testpath)."""
    views = list(range(rig.n_views)) if views is None else list(views)
    testpath = Path(root) / "acquisition" / "rig" if dataset_name == "bin" else Path(root)
    pair_dir = testpath / ".." / ".." if dataset_name == "bin" else testpath
    for v in views:
        cam = testpath / DICT_CAM_SUBFOLDER[dataset_name] / f"{v:0>8}_cam.txt"
        img = testpath / DICT_IMG_SUBFOLDER[dataset_name].format(scan, v + 1 if dataset_name == "dtu" else v)
        for path in (cam, img):
            path.parent.mkdir(parents=True, exist_ok=True)
        rig.write_cam_file(str(cam), v, ndepths)
        jimages.save_image_u8(str(img), rig.render(v))
    pairs = [(ref, [s for s in srcs if s in views]) for ref, srcs in rig.pair_list() if ref in views]
    jcams.write_pair_file(str(pair_dir / pairfile), pairs)
    return testpath


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Every dataset layout from the JAX package's synthetic scenes: DTU
    train, Blender train, the unified eval and the legacy 1200x1600 evals."""
    root = tmp_path_factory.mktemp("trees")
    rig = synthetic.SyntheticRig(n_views=4, img_hw=(64, 96), baseline=3.0)
    synthetic.make_dtu_tree(str(root / "dtu"), rig=rig, ndepths=16)
    synthetic.make_blender_tree(str(root / "blender"), n_lights=3, rig=rig, ndepths=16)
    synthetic.make_eval_tree(str(root / "eval"), rig=rig, ndepths=16)
    legacy = root / "dtu_eval"
    synthetic.make_legacy_dtu_eval_tree(str(legacy), ndepths=8)
    bds = root / "bds_eval"  # the same scene in the legacy Blender layout
    os.makedirs(bds / "Rectified_1200x1600" / "scan1")
    shutil.copytree(legacy / "Cameras", bds / "Cameras_1200x1600")
    for v in range(3):
        shutil.copy(legacy / "Rectified_raw" / "scan1" / f"rect_{v + 1:0>3}_3_r5000.png",
                    bds / "Rectified_1200x1600" / "scan1" / f"rect_C{v:0>3}_L00.png")
    for name in ("dtu", "blender", "eval", "dtu_eval", "bds_eval"):
        synthetic.write_scan_list(str(root / name / "list.txt"), ["scan1"] if name != "blender" else ["scene_000"])
    # the bds8 and bin registries' own layouts at their 512x640: 4 of a 49-camera ring, and a 4-camera ring
    bds8 = registry_tree(root / "bds8", "bds8", synthetic.RingRig(n_views=49), "scene_000", 16,
                         views=BDS8_VIEWS, pairfile=BDS8_PAIRFILE)
    synthetic.write_scan_list(str(bds8 / "list.txt"), ["scene_000"])
    bin_ = registry_tree(root / "bin", "bin", synthetic.RingRig(n_views=4), "binpicking", 16)
    synthetic.write_scan_list(str(bin_ / "list.txt"), ["binpicking"])
    return root


DATASETS = {
    "dtu_yao": ("dtu", "train", 3, {}),
    "blender": ("blender", "train", 3, {"Nlights": "2:3", "seed": 5}),
    "blender-val": ("blender", "val", 2, {"Nlights": "3:3", "seed": 6}),
    "dataloader_eval": ("eval", "test", 3, {"cam_subfolder": "Cameras", "img_res": (64, 96), "dataset_name": "bds8",
                                            "img_subfolder": "Rectified/{}/rect_C{:0>3}_L00.png", "emit_u8": True}),
    "dataloader_eval-f32": ("eval", "test", 2, {"cam_subfolder": "Cameras", "img_res": (32, 64), "dataset_name": "bds1",
                                                "img_subfolder": "Rectified/{}/rect_C{:0>3}_L00.png"}),
    "dtu_yao_eval": ("dtu_eval", "test", 3, {}),
    "blender_eval": ("bds_eval", "test", 2, {}),
    # eval.py's registries, no overrides: the bin's pair file two directories up
    **{f"dataloader_eval-{name}": (folder, "test", 4, {
        "cam_subfolder": DICT_CAM_SUBFOLDER[name], "img_subfolder": DICT_IMG_SUBFOLDER[name],
        "img_res": DICT_IMG_RES[name], "dataset_name": name, **extra})
       for name, folder, extra in (("bds8", "bds8", {"pairfile": BDS8_PAIRFILE}),
                                   ("bin", "bin/acquisition/rig", {}))},
}


def _datasets(trees, key):
    folder, mode, nviews, kw = DATASETS[key]
    name = key.split("-")[0]
    args = (str(trees / folder), str(trees / folder / "list.txt"), mode, nviews, 16, 1.06)
    return tdata.find_dataset_def(name)(*args, **kw), jdata.find_dataset_def(name)(*args, **kw)


@pytest.mark.parametrize("key", list(DATASETS))
def test_dataset_matches_jax(trees, key):
    """The same metas and, for two of them, every field the port's sample
    holds, equal to the JAX dataset's."""
    ours, theirs = _datasets(trees, key)
    assert len(ours) == len(theirs) > 0 and ours.metas == theirs.metas
    for idx in (0, len(ours) - 1):
        got, want = ours[idx], theirs[idx]
        for k, v in got.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == want[k].dtype, k
                np.testing.assert_array_equal(v, want[k], err_msg=k)
            else:
                assert v == want[k], k


def test_find_dataset_def_refuses_unknown():
    with pytest.raises(KeyError, match="available"):
        tdata.find_dataset_def("nope")


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_matches_jax(trees, num_workers, drop_last):
    """Shuffled batches of 5 from 28 DTU samples: the same batches in the
    same order over two epochs, and the background loader's u8 packing."""
    ours_ds, _ = _datasets(trees, "dtu_yao")
    kw = dict(batch_size=5, shuffle=True, drop_last=drop_last, num_workers=num_workers, seed=3)
    ours, theirs = tdata.Loader(ours_ds, **kw), jdata.Loader(ours_ds, **kw)
    assert len(ours) == len(theirs) == (5 if drop_last else 6)
    for _ in range(2):
        got = list(tdata.BackgroundLoader(ours, transform=tdata.pack_u8_imgs))
        want = [jdata.pipeline.pack_u8_imgs(b) for b in theirs]
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and g["imgs"].dtype == np.uint8
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_background_loader_raises_the_producers_error():
    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            if i == 2:
                raise RuntimeError("sample 2 is broken")
            return {"x": np.zeros(2)}

    it = iter(tdata.BackgroundLoader(tdata.Loader(Broken(), batch_size=1)))
    assert next(it)["x"].shape == (1, 2)
    with pytest.raises(RuntimeError, match="sample 2"):
        list(it)
