"""Stage A's host input against the device forward at the DTU-full eval
resolution: the counterpart of ``scripts/profile_input.py``.

    python -m scene_3dreconstruction_mvsnet_tpu_torch.bench.profile_input [--res H W] [--views N]

Writes a synthetic eval scan at 864x1152 (``data/synthetic.py``), then
times one sample of the ``dataloader_eval`` dataset (its N views decoded,
rescaled and cropped), one view's PNG decode, one view's decode + rescale
+ crop (``io/images.py::read_rescale_crop_img``) and one ``np.load`` of a
pre-decoded view. Where the script prints a fixed forward time, this one
measures the forward at the same resolution on the device: the bf16 MVSNet
on the sample's views and 192 planes, timed as in ``headline.py``. Prints
the script's lines and one JSON line.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch
from PIL import Image

from ..data import find_dataset_def
from ..data.synthetic import SyntheticRig, make_eval_tree, write_scan_list
from ..io.images import read_rescale_crop_img
from . import add_common_args, emit, platform_fields, resolve_device
from .headline import build_model, sustained_seconds

FORWARD_ITERS = 5


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(p)
    p.add_argument("--res", type=int, nargs=2, default=(864, 1152), metavar=("H", "W"))
    p.add_argument("--views", type=int, default=5)
    p.add_argument("--numdepth", type=int, default=192, help="depth planes (tests only)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    res, n_views, ndepths = tuple(args.res), args.views, args.numdepth

    os.makedirs(args.out, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="profile_input_", dir=args.out)
    rig = SyntheticRig(n_views=max(6, n_views + 1), img_hw=res, focal=0.9 * res[1])
    t0 = time.time()
    make_eval_tree(tmp, scan="scan1", rig=rig, ndepths=ndepths)
    print(f"fixture tree ({rig.n_views} views @ {res[0]}x{res[1]}): {time.time() - t0:.1f}s")
    write_scan_list(os.path.join(tmp, "eval.txt"), ["scan1"])
    ds = find_dataset_def("dataloader_eval")(
        tmp, os.path.join(tmp, "eval.txt"), "test", n_views, ndepths, cam_subfolder="Cameras",
        img_subfolder="Rectified/{}/rect_C{:0>3}_L00.png", img_res=res, dataset_name="profile",
    )

    iters = 5
    sample = ds[0]  # warms the page cache
    t0 = time.time()
    for i in range(iters):
        ds[i % len(ds)]
    per_sample = (time.time() - t0) / iters

    img_path = os.path.join(tmp, "Rectified", "scan1", "rect_C000_L00.png")
    t0 = time.time()
    for _ in range(iters):
        np.asarray(Image.open(img_path))
    decode = (time.time() - t0) / iters
    t0 = time.time()
    for _ in range(iters):
        read_rescale_crop_img(img_path, rig.K.copy(), img_res=res)
    decode_plus_prep = (time.time() - t0) / iters

    imgs = torch.as_tensor(sample["imgs"])[None].float().to(device)
    proj = torch.as_tensor(sample["proj_matrices"])[None].to(device)
    dv = torch.as_tensor(sample["depth_values"])[None].to(device)
    forward = sustained_seconds(build_model(device), imgs, proj, dv, FORWARD_ITERS)

    cache = os.path.join(tmp, "cache.npy")
    np.save(cache, read_rescale_crop_img(img_path, rig.K.copy(), img_res=res)[0])
    t0 = time.time()
    for _ in range(iters):
        np.load(cache)
    npy_read = (time.time() - t0) / iters
    shutil.rmtree(tmp, ignore_errors=True)

    non_image = per_sample - n_views * decode_plus_prep
    print(f"per-sample __getitem__ ({n_views} views):    {per_sample * 1e3:8.1f} ms")
    print(f"  PIL open+decode, per view:              {decode * 1e3:8.1f} ms")
    print(f"  decode + rescale/crop/f32, per view:    {decode_plus_prep * 1e3:8.1f} ms")
    print(f"  non-image overhead (cams, stacking):    {non_image * 1e3:8.1f} ms")
    print(f"forward at this res on {device.type} (measured, bf16, {n_views} views, D{ndepths}): "
          f"{forward * 1e3:8.1f} ms")
    print(f"host decode / device compute ratio:        {per_sample / forward:8.2f}x")
    print(f"  np.load of pre-decoded f32, per view:   {npy_read * 1e3:8.1f} ms")
    result = {
        "res": list(res), "views": n_views, "per_sample_ms": per_sample * 1e3, "decode_ms": decode * 1e3,
        "decode_prep_ms": decode_plus_prep * 1e3, "non_image_ms": non_image * 1e3, "forward_ms": forward * 1e3,
        "host_over_device": per_sample / forward, "npy_read_ms": npy_read * 1e3, **platform_fields(device),
    }
    return emit("profile_input", {"profile_input": result}, args.out)


if __name__ == "__main__":
    main()
