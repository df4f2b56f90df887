#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of MVSNet on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is not 0):
  1. device  the card's name, and name + power limit from nvidia-smi;
  2. build   the sweep-variance CUDA kernel (nvcc, sm_90a) and the
             softmax-regression Triton kernel, from the checkout's sources;
  3. kernels each kernel against its plain PyTorch version at the headline
             shapes (V=5, D=192, 216x288x32 features), with times from CUDA
             events;
  4. slice   MVSNet inference at the headline configuration (864x1152 images,
             5 views of a 49-camera inward ring, 192 planes, random weights
             from a seeded generator) serving requests through
             ``make_infer_step`` in f32 and bf16; outputs are checked, the f32
             run is held against the plain path, and both kernels' launch
             counts must cover every request.
The kernels' JSON line, then {"ok": true, "device": {...}} close the output.

There is no CPU fallback: without a CUDA device the script exits at once.
TF32 is off for the whole run, so f32 means f32 in every conv and matmul.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
V, H, W, D = 5, 864, 1152, 192
N_CAMS = 49
REF_CAMERAS = (0, 12, 24, 36)  # one request per reference camera of the ring
DEPTH_MIN, DEPTH_MAX = 425.0, 905.0

SWEEP_ATOL_F32 = 1e-4  # x max|ref|; f32 features, same coordinates, other rounding order
SWEEP_ATOL_BF16 = 2e-3  # x max|ref|; bf16 features: the tolerance JAX holds its TPU kernel to
REG_DEPTH_TOL = 1e-4  # x depth range
REG_CONF_ATOL = 1e-5
INT_BAND = 1e-4  # expected indices this close to an integer (beyond the measured
#                  disagreement) may truncate either way; see near_integer_index
SLICE_DEPTH_TOL = 1e-3  # x depth range, as the JAX package holds its model to torch
SLICE_CONF_ATOL = 1e-4


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, from CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_pair(kernel_fn, plain_fn, iters: int, plain_iters: int) -> tuple[float, float]:
    """Warm both, then time plain, kernel, kernel, plain; the mean of each pair."""
    import torch

    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    p1 = cuda_time_ms(plain_fn, plain_iters)
    k1 = cuda_time_ms(kernel_fn, iters)
    k2 = cuda_time_ms(kernel_fn, iters)
    p2 = cuda_time_ms(plain_fn, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def headline_rig(ref: int):
    """Feature-resolution projections [V, 4, 4] of ring camera ``ref`` and
    its 4 nearest ring neighbours, and the depth hypotheses [D]."""
    import numpy as np

    from bench import ring_projs

    K = np.array([[W * 1.1, 0, W / 2], [0, W * 1.1, H / 2], [0, 0, 1]], np.float32)
    views = [ref % N_CAMS, (ref + 1) % N_CAMS, (ref - 1) % N_CAMS, (ref + 2) % N_CAMS, (ref - 2) % N_CAMS]
    projs = ring_projs(N_CAMS, views, 150.0, -700.0, 700.0, K / 4.0)
    return projs, np.linspace(DEPTH_MIN, DEPTH_MAX, D, dtype=np.float32)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("device", f"{name}; capability {torch.cuda.get_device_capability(0)}; "
                  f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    return name, smi


def phase_build():
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import build_cuda_library
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.softmax_regression import softmax_regression_cuda

    _, k1_s, report = build_cuda_library("sweep_variance")
    ptxas = [line.strip() for line in report.splitlines() if "registers" in line or "spill" in line]
    t0 = time.perf_counter()
    # the first launch compiles the Triton kernel for the headline's specialisation
    cost = torch.zeros((1, D, H // 4, W // 4), device="cuda")
    dv = torch.linspace(DEPTH_MIN, DEPTH_MAX, D, device="cuda")[None]
    softmax_regression_cuda(cost, dv)
    torch.cuda.synchronize()
    k2_s = time.perf_counter() - t0
    log("build", f"sweep_variance.cu (nvcc sm_90a) {k1_s:.2f} s; softmax_regression (triton) {k2_s:.2f} s")
    for line in ptxas:
        log("build", f"ptxas: {line}")


def phase_kernels(gen) -> list[dict]:
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.softmax_regression import softmax_regression_cuda
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.sweep_variance import sweep_variance_cuda
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.plane_sweep import cost_volume_variance
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.regression import regress_depth_and_confidence

    dev = torch.device("cuda")
    projs, dv = headline_rig(REF_CAMERAS[0])
    proj = torch.from_numpy(projs).to(dev)[None]
    depth_values = torch.from_numpy(dv).to(dev)[None]
    feats = torch.rand((1, V, H // 4, W // 4, 32), generator=gen, device=dev)
    rows = []

    with torch.inference_mode():
        # K1, f32 features and output
        ref = cost_volume_variance(feats, proj, depth_values)[0]
        out = sweep_variance_cuda(feats[0], proj[0], depth_values[0])
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err_f32 = (out - ref).abs().max().item()
        del ref, out
        # K1, bf16 features, f32 output
        feats_bf = feats.to(torch.bfloat16)
        ref = cost_volume_variance(feats_bf, proj, depth_values, out_dtype=torch.float32)[0]
        out = sweep_variance_cuda(feats_bf[0], proj[0], depth_values[0], out_dtype=torch.float32)
        torch.cuda.synchronize()
        scale_bf = ref.abs().max().item()
        err_bf = (out - ref).abs().max().item()
        del ref, out
        log("kernels", f"sweep_variance f32: max|err| {err_f32:.3e} vs atol {SWEEP_ATOL_F32 * scale:.3e} "
                       f"(max|ref| {scale:.4f}); bf16 in/f32 out: max|err| {err_bf:.3e} vs atol "
                       f"{SWEEP_ATOL_BF16 * scale_bf:.3e}")
        if not err_f32 <= SWEEP_ATOL_F32 * scale or not err_bf <= SWEEP_ATOL_BF16 * scale_bf:
            raise AssertionError("sweep_variance kernel disagrees with its plain version")
        # time the main path's bf16 configuration: bf16 features -> bf16 volume
        k_ms, p_ms = timed_pair(
            lambda: sweep_variance_cuda(feats_bf[0], proj[0], depth_values[0]),
            lambda: cost_volume_variance(feats_bf, proj, depth_values),
            iters=10, plain_iters=3,
        )
        k_ms32, p_ms32 = timed_pair(
            lambda: sweep_variance_cuda(feats[0], proj[0], depth_values[0]),
            lambda: cost_volume_variance(feats, proj, depth_values),
            iters=10, plain_iters=3,
        )
        log("kernels", f"sweep_variance bf16->bf16: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; "
                       f"f32->f32: kernel {k_ms32:.3f} ms, plain {p_ms32:.3f} ms")
        rows.append({
            "name": "sweep_variance", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/sweep_variance.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/sweep_variance.py:607",
            "max_abs_err": err_f32, "ms": k_ms, "plain_ms": p_ms,
            "max_abs_err_bf16": err_bf, "ms_f32": k_ms32, "plain_ms_f32": p_ms32,
        })
        del feats, feats_bf

        # K2 on logits of the scale the U-Net emits
        cost = torch.randn((1, D, H // 4, W // 4), generator=gen, device=dev) * 3.0
        ref_depth, ref_conf = regress_depth_and_confidence(cost, depth_values)
        depth, conf = softmax_regression_cuda(cost, depth_values)
        torch.cuda.synchronize()
        d_diff = (depth - ref_depth).abs()
        near_int = near_integer_index(ref_depth, d_diff)
        n_excl = int(near_int.sum().item())
        d_err = d_diff.max().item()
        c_err = (conf - ref_conf).abs()[~near_int].max().item()
        log("kernels", f"softmax_regression: depth max|err| {d_err:.3e} vs {REG_DEPTH_TOL * (DEPTH_MAX - DEPTH_MIN):.3e}; "
                       f"conf max|err| {c_err:.3e} vs {REG_CONF_ATOL:.0e}; {n_excl} of {near_int.numel()} "
                       f"pixels excluded (expected index near an integer)")
        if not d_err <= REG_DEPTH_TOL * (DEPTH_MAX - DEPTH_MIN) or not c_err <= REG_CONF_ATOL:
            raise AssertionError("softmax_regression kernel disagrees with its plain version")
        k_ms, p_ms = timed_pair(
            lambda: softmax_regression_cuda(cost, depth_values),
            lambda: regress_depth_and_confidence(cost, depth_values),
            iters=50, plain_iters=20,
        )
        log("kernels", f"softmax_regression: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        rows.append({
            "name": "softmax_regression", "route": "triton",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/ops/kernels/softmax_regression.py",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/softmax_regression.py:86",
            "max_abs_err": d_err, "ms": k_ms, "plain_ms": p_ms,
            "conf_max_abs_err": c_err, "excluded_pixels": n_excl,
        })
    return rows


def near_integer_index(depth_plain, depth_diff):
    """Pixels where the truncated expected plane index may legitimately differ
    between two paths: the plain path's expected index (linear in depth, as
    the hypotheses are evenly spaced) lies within the two paths' measured
    disagreement plus INT_BAND of an integer."""
    per_depth = (D - 1) / (DEPTH_MAX - DEPTH_MIN)
    e_idx = (depth_plain - DEPTH_MIN) * per_depth
    return (e_idx - e_idx.round()).abs() < depth_diff * per_depth + INT_BAND


def check_maps(depth, conf, tag: str) -> None:
    import torch

    shape = (1, H // 4, W // 4)
    slack = 1e-4 * (DEPTH_MAX - DEPTH_MIN)  # an f32 expectation may round just past the ends
    ok = (
        tuple(depth.shape) == shape and tuple(conf.shape) == shape
        and bool(torch.isfinite(depth).all()) and bool(torch.isfinite(conf).all())
        and depth.min().item() >= DEPTH_MIN - slack and depth.max().item() <= DEPTH_MAX + slack
        and conf.min().item() >= 0.0 and conf.max().item() <= 1.0 + 1e-5
    )
    if not ok:
        raise AssertionError(
            f"{tag}: bad output: shapes {tuple(depth.shape)} {tuple(conf.shape)}, depth "
            f"[{depth.min().item()}, {depth.max().item()}], conf [{conf.min().item()}, {conf.max().item()}]"
        )


def phase_slice(gen) -> dict[str, int]:
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import cost_volume_variance, regress_depth_and_confidence
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import softmax_regression as k2
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import sweep_variance as k1

    dev = torch.device("cuda")
    model32 = random_init_(MVSNet().to(dev), gen)
    model16 = MVSNet(dtype=torch.bfloat16).to(dev)
    model16.load_state_dict(model32.state_dict())
    steps = {"f32": make_infer_step(model32, dev), "bf16": make_infer_step(model16, dev)}

    host_gen = torch.Generator().manual_seed(SEED)
    requests = []
    for ref in REF_CAMERAS:
        projs, dv = headline_rig(ref)
        imgs = torch.randint(0, 256, (1, V, H, W, 3), generator=host_gen, dtype=torch.uint8)
        requests.append((imgs, torch.from_numpy(projs)[None], torch.from_numpy(dv)[None]))

    torch.cuda.synchronize()
    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    outputs, seconds = {}, {}
    for tag, step in steps.items():
        outputs[tag], seconds[tag] = [], []
        for imgs, proj, dv in requests:
            t0 = time.perf_counter()
            out = step(imgs, proj, dv)
            torch.cuda.synchronize()
            seconds[tag].append(time.perf_counter() - t0)
            outputs[tag].append(out)
    launches = {"sweep_variance": k1.LAUNCHES, "softmax_regression": k2.LAUNCHES}
    n_req = len(requests) * len(steps)
    log("slice", f"served {n_req} requests; kernel launches {launches}")
    if min(launches.values()) < n_req:
        raise AssertionError(f"a kernel was launched fewer times than the {n_req} requests: {launches}")

    for tag in steps:
        for i, out in enumerate(outputs[tag]):
            check_maps(out["depth"], out["photometric_confidence"], f"{tag} request {i}")

    # the f32 kernel path against the plain path (plain functions called directly)
    rng_ = DEPTH_MAX - DEPTH_MIN
    with torch.inference_mode():
        for i, (imgs, proj, dv) in enumerate(requests):
            x = imgs.to(dev).float() / 255.0
            proj, dv = proj.to(dev), dv.to(dev)
            feats = model32.feature(x.reshape(V, H, W, 3)).reshape(1, V, H // 4, W // 4, 32)
            volume = cost_volume_variance(feats, proj, dv)
            cost_reg = model32.cost_regularization(volume)[..., 0].float()
            del volume
            ref_depth, ref_conf = regress_depth_and_confidence(cost_reg, dv)
            out = outputs["f32"][i]
            d_diff = (out["depth"] - ref_depth).abs()
            near_int = near_integer_index(ref_depth, d_diff)
            c_err = (out["photometric_confidence"] - ref_conf).abs()[~near_int].max().item()
            d_err = d_diff.max().item()
            log("slice", f"f32 request {i} vs plain path: depth max|err| {d_err:.3e} vs {SLICE_DEPTH_TOL * rng_:.3e}; "
                         f"conf max|err| {c_err:.3e} vs {SLICE_CONF_ATOL:.0e}; "
                         f"{int(near_int.sum().item())} pixels excluded near an integer index")
            if not d_err <= SLICE_DEPTH_TOL * rng_ or not c_err <= SLICE_CONF_ATOL:
                raise AssertionError(f"f32 request {i}: kernel path disagrees with the plain path")

    for tag in steps:
        s = seconds[tag]
        steady = statistics.median(s[1:]) if len(s) > 1 else s[0]
        log("slice", f"{tag}: seconds per depth map {', '.join(f'{t:.4f}' for t in s)} "
                     f"(median after the first: {steady:.4f})")
    log("slice", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main() -> None:
    import torch

    repo = Path(__file__).resolve().parent
    if not (repo / "scene_3dreconstruction_mvsnet_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository (the port's package is missing)")
    sys.path.insert(0, str(repo))

    name, smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    phase_build()
    rows = phase_kernels(gen)
    launches = phase_slice(gen)
    for row in rows:
        row["launches"] = launches[row["name"]]

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "scene_3dreconstruction_mvsnet_tpu"))
    if leaked:
        raise AssertionError(f"the port pulled in JAX or the JAX package: {leaked[:5]}")

    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
