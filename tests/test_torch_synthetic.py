"""The port's synthetic scenes (``data/synthetic.py``) against the JAX
package's: the same rigs (cameras, depth maps, renders, pair lists) and,
for the same arguments, the same bytes in every file of every dataset
layout."""

import os

import numpy as np
import pytest

from scene_3dreconstruction_mvsnet_tpu.data import synthetic as jsyn
from scene_3dreconstruction_mvsnet_tpu_torch.data import synthetic as tsyn


def _files(root) -> dict[str, bytes]:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("make,kw", [
    ("make_blender_tree", {"n_lights": 2, "rig": ("SyntheticRig", {"n_views": 3, "img_hw": (32, 48)})}),
    ("make_dtu_tree", {"rig": ("SyntheticRig", {"n_views": 3, "img_hw": (32, 32), "baseline": 4.0}), "ndepths": 8}),
    ("make_eval_tree", {"rig": ("RingRig", {"n_views": 5, "img_hw": (48, 64)}), "ndepths": 16}),
    ("make_legacy_dtu_eval_tree", {}),
], ids=["blender", "dtu", "eval_ring", "legacy_dtu_eval"])
def test_trees_are_byte_equal(tmp_path, make, kw):
    """Each make_*_tree of the port writes the JAX module's files, byte for
    byte (the legacy DTU tree at its own 1200x1600 three-view default);
    write_scan_list too."""
    trees = {}
    for tag, mod in (("jax", jsyn), ("port", tsyn)):
        args = dict(kw)
        if "rig" in args:
            cls, rig_kw = args["rig"]
            args["rig"] = getattr(mod, cls)(**rig_kw)
        root = tmp_path / tag
        rig = getattr(mod, make)(str(root), **args)
        mod.write_scan_list(str(root / "list.txt"), ["scan1", "scan2"])
        assert type(rig).__name__ == (kw["rig"][0] if "rig" in kw else "SyntheticRig")
        trees[tag] = _files(root)
    assert len(trees["jax"]) > 4 and trees["port"].keys() == trees["jax"].keys()
    for name, data in trees["jax"].items():
        assert trees["port"][name] == data, name


@pytest.mark.parametrize("cls,kw", [("SyntheticRig", {"n_views": 4, "img_hw": (24, 40)}),
                                    ("RingRig", {"n_views": 7, "img_hw": (40, 56)})])
def test_rigs_are_equal(cls, kw):
    """The rigs' cameras, depth maps (full and 1/4 scale), renders, depth
    ranges and pair lists, exactly."""
    a, b = getattr(jsyn, cls)(**kw), getattr(tsyn, cls)(**kw)
    np.testing.assert_array_equal(a.K, b.K)
    assert a.depth_range() == b.depth_range() and a.pair_list() == b.pair_list()
    for v in range(kw["n_views"]):
        np.testing.assert_array_equal(a.extrinsics(v), b.extrinsics(v))
        np.testing.assert_array_equal(a.render(v), b.render(v))
        for scale in (1, 4):
            np.testing.assert_array_equal(a.depth_map(v, scale), b.depth_map(v, scale))
