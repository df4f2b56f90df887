"""Readers of the eval's file formats, plain numpy and Pillow: PFM, cam
and pair text files, PNG images and masks, binary PLY."""

from __future__ import annotations

import re

import numpy as np
from PIL import Image


def read_pfm(path: str) -> np.ndarray:
    """A greyscale PFM -> [H, W] f32, top row first."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"Pf":
            raise ValueError(f"{path}: not a greyscale PFM")
        width, height = (int(v) for v in re.findall(rb"\d+", f.readline()))
        scale = float(f.readline())
        data = np.fromfile(f, dtype="<f4" if scale < 0 else ">f4")
    return np.flipud(data.reshape(height, width)).astype(np.float32)


def read_cam(path: str) -> tuple[np.ndarray, np.ndarray, float, float]:
    """-> (K [3, 3], E [4, 4] world->camera, depth_min, depth_interval), f64."""
    with open(path) as f:
        lines = [line.strip() for line in f]
    E = np.array([[float(v) for v in lines[i].split()] for i in range(1, 5)])
    K = np.array([[float(v) for v in lines[i].split()] for i in range(7, 10)])
    depth_min, interval = (float(v) for v in lines[11].split()[:2])
    return K, E, depth_min, interval


def read_pairs(path: str) -> list[tuple[int, list[int]]]:
    with open(path) as f:
        n = int(f.readline())
        out = []
        for _ in range(n):
            ref = int(f.readline())
            out.append((ref, [int(v) for v in f.readline().split()[1::2]]))
    return out


def read_png(path: str) -> np.ndarray:
    return np.asarray(Image.open(path))


def read_ply_points(path: str) -> np.ndarray:
    """The x, y, z of a binary little-endian PLY's vertices -> [N, 3] f32."""
    with open(path, "rb") as f:
        n = 0
        while (line := f.readline().strip()) != b"end_header":
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
        data = np.fromfile(f, dtype=np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]), count=n)
    return data["xyz"]
