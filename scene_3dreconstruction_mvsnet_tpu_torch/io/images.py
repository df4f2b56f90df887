"""Image reads, writes and the eval loader's rescale-and-crop, with Pillow.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/io/images.py``, giving the
same pixels and files, its decoded-image caches (``--img_cache``) included:
the same keys and file formats, so one cache directory serves both
packages.
"""

from __future__ import annotations

import hashlib
import math
import os
import threading
from collections import OrderedDict

import numpy as np
from PIL import Image

BASE_IMAGE_SIZE = 32  # FeatureNet divides by 4 and the U-Net by 8 more: crops are multiples of 32


def read_img(filename: str) -> np.ndarray:
    """An image as float32 in [0, 1], [H, W] or [H, W, C]."""
    return np.asarray(Image.open(filename), dtype=np.float32) / 255.0


def read_mask(filename: str) -> np.ndarray:
    """A binary mask: True where the pixel exceeds 0.5 after 0-1 scaling."""
    return read_img(filename) > 0.5


def save_mask(filename: str, mask: np.ndarray) -> None:
    """A boolean mask as an 8-bit PNG, 255 where True."""
    if mask.dtype != np.bool_:
        raise ValueError(f"mask dtype must be bool, got {mask.dtype}")
    Image.fromarray(mask.astype(np.uint8) * 255).save(filename)


def save_image_u8(filename: str, img01: np.ndarray) -> None:
    """An image as 8-bit: u8 pixels are written as they are, floats in
    [0, 1] are clipped and truncated to u8. PNGs are written at zlib level 1
    (the writes run beside the device's work; the files are scratch
    outputs)."""
    arr = np.asarray(img01)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    im = Image.fromarray(arr)
    if filename.endswith(".png"):
        im.save(filename, compress_level=1)
    else:
        im.save(filename)


def resize_img(img01: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a u8 or [0, 1] float image to (H, W), in the u8
    domain; float32 in [0, 1] out."""
    img01 = np.asarray(img01)
    u8 = img01 if img01.dtype == np.uint8 else (np.clip(img01, 0.0, 1.0) * 255.0).astype(np.uint8)
    out = np.asarray(Image.fromarray(u8).resize((hw[1], hw[0]), Image.BILINEAR), dtype=np.float32)
    return out / 255.0


def read_rescale_crop_img(
    img_fname: str,
    intrinsics: np.ndarray,
    img_res: tuple[int, int] = (512, 640),
    return_u8: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Load an image, rescale it to cover ``img_res``, centre-crop it to the
    target (or down to a multiple of 32 where the rescaled side falls short)
    and adjust ``intrinsics`` in place to match, as the reference's
    ``data_io.py`` does; a grey image is stacked to 3 channels. Returns
    (u8 pixels when ``return_u8``, else float32 in [0, 1]; intrinsics).
    Upscaling is refused."""
    img = Image.open(img_fname)
    w_src, h_src = img.size
    h_target, w_target = img_res
    h_scale, w_scale = float(h_target) / h_src, float(w_target) / w_src
    if h_scale > 1 or w_scale > 1:
        raise ValueError(f"{img_fname}: target {img_res} exceeds source ({h_src},{w_src}); "
                         "image resolution can only be reduced")
    scale = max(h_scale, w_scale)
    img = img.resize((int(w_src * scale), int(h_src * scale)), resample=Image.BILINEAR)
    w_res, h_res = img.size
    intrinsics[:2, :] *= scale
    final_h = h_target if h_res > h_target else int(math.floor(h_target / BASE_IMAGE_SIZE) * BASE_IMAGE_SIZE)
    final_w = w_target if w_res > w_target else int(math.floor(w_target / BASE_IMAGE_SIZE) * BASE_IMAGE_SIZE)
    start_h, start_w = int(math.floor((h_res - final_h) / 2)), int(math.floor((w_res - final_w) / 2))
    img = img.crop((start_w, start_h, start_w + final_w, start_h + final_h))
    intrinsics[0, -1] -= start_w
    intrinsics[1, -1] -= start_h
    np_img = np.asarray(img, dtype=np.uint8) if return_u8 else np.asarray(img, dtype=np.float32) / 255.0
    if np_img.ndim == 2:  # a black-and-white camera
        np_img = np.dstack((np_img, np_img, np_img))
    return np_img, intrinsics


def _cache_key(filename: str, *extra) -> str:
    """sha1 of the absolute path, the mtime in ns and the size (and
    ``extra``): an edited file is decoded again. The JAX package's key."""
    st = os.stat(filename)
    text = f"{os.path.abspath(filename)}|{st.st_mtime_ns}|{st.st_size}" + "".join(f"|{e}" for e in extra)
    return hashlib.sha1(text.encode()).hexdigest()


def _publish(path: str, save) -> None:
    """Write ``path`` through ``save(tmp)`` under a name of this writer's own
    (process and thread) and rename it into place, so concurrent loaders
    never read a partial file and never race for one temporary name."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ext = os.path.splitext(path)[1]  # numpy appends its extension unless the name ends with it
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp{ext}"
    save(tmp)
    os.replace(tmp, path)


def read_img_cached(filename: str, cache_dir: str) -> np.ndarray:
    """``read_img`` through a cache of the decoded f32 arrays, one
    ``<sha1>.npy`` per image (the JAX package's files: f32 in [0, 1], so
    either package reads what the other wrote). The array is read-only."""
    path = os.path.join(cache_dir, _cache_key(filename) + ".npy")
    if os.path.exists(path):
        img = np.load(path)
    else:
        img = read_img(filename)
        _publish(path, lambda tmp: np.save(tmp, img))
    img.setflags(write=False)
    return img


class DecodedImageLRU:
    """An in-process LRU over ``read_rescale_crop_img_cached``'s results, of
    at most ``budget`` bytes of image (the newest entry is kept whatever its
    size), behind a lock for the loader threads. Stage A reads each image
    about NviewGen times a scan."""

    def __init__(self, budget: int) -> None:
        self.budget = budget
        self.nbytes = 0
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
            return hit

    def put(self, key, img: np.ndarray, intrinsics: np.ndarray) -> None:
        with self._lock:
            if key in self._entries:
                return
            self._entries[key] = (img, intrinsics)
            self.nbytes += img.nbytes
            while self.nbytes > self.budget and len(self._entries) > 1:
                old, _ = self._entries.popitem(last=False)[1]
                self.nbytes -= old.nbytes

    def __len__(self) -> int:
        return len(self._entries)


IMAGE_LRU = DecodedImageLRU(768 << 20)


def read_rescale_crop_img_cached(
    img_fname: str,
    intrinsics: np.ndarray,
    img_res: tuple[int, int],
    cache_dir: str,
    return_u8: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """``read_rescale_crop_img`` through a cache of the rescaled and cropped
    image and its adjusted intrinsics, one ``<sha1>.npz`` per (image, target
    resolution), with hot entries served from ``IMAGE_LRU``. New entries
    store u8 pixels (lossless: the division by 255 is the uncached path's
    last step); f32 entries, which older JAX caches hold, are served too
    (rounded back to u8 when asked, exact as they came from u8 / 255).

    ``intrinsics`` is the camera matrix before the adjustment; the adjusted
    one is copied into it, as the uncached path adjusts it in place. The
    image is read-only: the LRU hands the same array to every reader."""
    key = _cache_key(img_fname, tuple(img_res))
    hit = IMAGE_LRU.get((key, bool(return_u8)))
    if hit is not None:
        intrinsics[:] = hit[1]
        return hit[0], intrinsics
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        with np.load(path) as data:
            img, intr = data["img"], data["intrinsics"]
    else:
        img, intr = read_rescale_crop_img(img_fname, intrinsics.copy(), img_res, return_u8=True)
        _publish(path, lambda tmp: np.savez(tmp, img=img, intrinsics=intr))
    if return_u8 and img.dtype != np.uint8:
        img = np.rint(img * 255.0).astype(np.uint8)
    elif not return_u8 and img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img.setflags(write=False)
    IMAGE_LRU.put((key, bool(return_u8)), img, np.array(intr))
    intrinsics[:] = intr
    return img, intrinsics
