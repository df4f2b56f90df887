"""Kernels written by hand for Hopper, their wrappers, and the CUDA build.

A CUDA C++ kernel lives in ``csrc/<name>.cu`` behind a plain C interface. At
first use it is compiled with ``nvcc`` for ``sm_90a`` into
``<repo>/build/kernels/<name>-<hash>.so`` and loaded with ``ctypes``; the hash
covers the source, the ``csrc/*.cuh`` headers it includes and the flags, so an
edited source or shared header rebuilds. Nothing here is built or imported
from a GPU toolchain when the module is imported.

Every wrapper launches through ``launch``, which counts each launch under one
of ``KERNEL_NAMES`` in one registry (``launch_counts`` reads it). A process
started with ``MVSNET_TORCH_LAUNCH_LOG=<file>`` in its environment appends
its counts to that file as one JSON line when it exits, so that a parent can
see which kernels its child processes launched.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

_PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_digest(src: Path) -> str:
    """Hash of ``src``, of every header it includes with ``#include "..."``
    (resolved beside it, followed transitively) and of the compiler flags:
    editing a shared header rebuilds every library that includes it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    seen, todo = set(), [src.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text + b"\0")
        todo += [(path.parent / m.decode()).resolve() for m in _LOCAL_INCLUDE.findall(text)]
    return h.hexdigest()[:16]


def build_cuda_library(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source (and
    of the headers it includes) exists.

    Returns (path of the shared library, seconds spent compiling, the
    compiler's output with ptxas' register and spill report; both empty/0
    when the build was already there)."""
    src = CSRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"{name}-{source_digest(src)}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    return lib, seconds, proc.stdout + proc.stderr


class KernelLibrary(ctypes.CDLL):
    """A kernel's shared library: ``error_string`` is its
    ``<name>_error_string`` (int -> message), and each entry point it hands
    out knows its library (``entry.library``), whose message ``launch``
    raises with."""

    def __init__(self, path: Path, name: str) -> None:
        super().__init__(str(path))
        self.name = name
        self.error_string = self[f"{name}_error_string"]
        self.error_string.argtypes = [ctypes.c_int]
        self.error_string.restype = ctypes.c_char_p

    def __getitem__(self, entry: str):
        fn = super().__getitem__(entry)
        fn.library = self
        return fn


@functools.lru_cache(maxsize=None)
def load_cuda_library(name: str) -> KernelLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``'s shared library."""
    path, _, _ = build_cuda_library(name)
    return KernelLibrary(path, name)


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor, floor: float = 0.0) -> float:
    """Largest |out - ref| in bf16 ulps of max(|out|, |ref|, floor), one
    bf16 ulp of a value v being at most 2^-7 |v|: the rule the bf16 kernels
    are held to against their plain versions."""
    diff = (out.float() - ref.float()).abs()
    mag = torch.maximum(out.float().abs(), ref.float().abs()).clamp_min(floor)
    return (diff / (2.0 ** -7 * mag).clamp_min(1e-30)).max().item()


def check_cuda_tensor(t: torch.Tensor, name: str, dtypes, ndim: int, device, align: int = 16) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes`` with
    ``ndim`` dims on ``device``, aligned to ``align`` bytes: what a kernel
    takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


LAUNCH_LOG_ENV = "MVSNET_TORCH_LAUNCH_LOG"
# the names a launch counts under: K1's builds (one depth per plane, the same
# with the emitted warps, per-pixel depths) and K2's (per plane, per pixel)
# apart, BatchNorm's three passes (1 launch an eval forward, 3 a training
# forward, 3 a backward) and CostRegNet's prob conv (1 launch a forward, up to
# 3 a backward)
KERNEL_NAMES = ("sweep_variance", "sweep_variance_emit", "softmax_regression", "paired_grad", "warp_grad",
                "conv0_fused", "plane_sweep_warp", "sweep_variance_per_pixel", "softmax_regression_per_pixel",
                "batch_norm_eval", "batch_norm_train", "batch_norm_backward", "prob_conv", "prob_conv_backward")
_LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)  # the registry; only ``launch`` adds to it


def launch(entry, *args, device: torch.device, name: str, launches: int = 1) -> None:
    """Call the C entry point ``entry`` (of a ``KernelLibrary``) with
    ``args`` and the device's current stream, under the device's guard, and
    count ``launches`` kernel launches under ``name`` (one of
    ``KERNEL_NAMES``). A nonzero return raises ``RuntimeError`` with the
    library's own message and counts nothing."""
    if name not in _LAUNCHES:
        raise ValueError(f"{name!r} is not one of the kernel names {KERNEL_NAMES}")
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        lib = entry.library
        raise RuntimeError(f"{lib.name} kernel launch failed: {lib.error_string(err).decode()}")
    _LAUNCHES[name] += launches


def launch_counts() -> dict[str, int]:
    """Each kernel's launches in this process since the last reset, by name
    (``KERNEL_NAMES``)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _LAUNCHES.update(dict.fromkeys(KERNEL_NAMES, 0))


def read_launch_log(path: str | os.PathLike) -> dict[str, int]:
    """The launches that the processes logging to ``path`` made, summed
    (zeros when none wrote there)."""
    total = dict.fromkeys(KERNEL_NAMES, 0)
    if os.path.exists(path):
        for line in Path(path).read_text().splitlines():
            for name, n in json.loads(line)["launches"].items():
                total[name] += n
    return total


def _log_launches(path: str) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"pid": os.getpid(), "argv": sys.argv, "launches": launch_counts()}) + "\n")


if os.environ.get(LAUNCH_LOG_ENV):
    atexit.register(_log_launches, os.environ[LAUNCH_LOG_ENV])
