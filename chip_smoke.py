#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of MVSNet on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (each prints lines tagged with its name; any failure raises and the
exit code is not 0):
  1. device  the card's name, and name + power limit from nvidia-smi;
  2. build   the sweep-variance, paired backward-terms, warp-backward,
             fused-conv0 and single-view warp CUDA kernels (nvcc, sm_90a, one
             compiler process each, started together) and the
             softmax-regression Triton kernel, from the checkout's sources;
  3. kernels each kernel against its plain PyTorch version, with times from
             CUDA events: K1, K2, K4 (and the module conv0 it replaces) and
             K5 at the inference headline's shapes (V=5, D=192, 216x288x32
             features), K1's emit mode, K3-terms and K3 at the training
             recipe's (V=3, D=192, 128x160x32; K3 also twice for bit
             equality);
  4. slice   MVSNet inference at the headline configuration (864x1152 images,
             5 views of a 49-camera inward ring, 192 planes, random weights
             from a seeded generator) serving requests through
             ``make_infer_step`` in f32, bf16 and bf16 with the fused conv0
             K4 (its depth maps held against bf16's); outputs are checked, the f32
             run is held against the plain path, and K1's and K2's launch
             counts must cover every request;
  5. train   MVSNet training at the train_DTU recipe (batch 4, 3 views,
             512x640, D=192, interval 2.65, Adam lr 1e-3) through the port's
             train step on an analytic plane scene: 6 bf16 steps on one
             repeated batch (the loss must fall) and 2 f32 steps, K1-emit
             once per sample and K3-terms and K3 once per step, the paired
             sweep's feature gradient
             held against autograd through the plain sweep, and the step's
             seconds, peak memory, stage split and device idle share;
  6. eval    the two-stage eval CLI (``eval_cli``) on a synthetic 16-view ring
             acquisition at 864x1152 (5 views per depth map, 192 planes,
             bf16, random weights) that this script renders itself: stage
             A + B with the fused conv0, stage A without it (the depth maps
             must agree), --serve on two scans and --debug_MVSnet 2; every
             file is checked, K4 must launch once per depth map and K5 once
             per dumped source view. The CLI's own output goes to
             build/eval_smoke/eval_cli.log.
The kernels' JSON line, then {"ok": true, "device": {...}} close the output.

There is no CPU fallback: without a CUDA device the script exits at once.
TF32 is off for the whole run, so f32 means f32 in every conv and matmul.
Nothing of JAX or of the JAX package is imported, by this script or by the
port it drives; the script fails if either was.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
V, H, W, D = 5, 864, 1152, 192
N_CAMS = 49
RING_RADIUS, RING_HEIGHT, RING_Z0 = 150.0, -700.0, 700.0  # mm: bench.py's ring, the DTU/BDS8 overhead rig
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

# the train_DTU recipe (configs/workloads.json): batch 4, 3 views, 512x640
# images, 192 planes from 425 mm at 2.5 mm x interval_scale 1.06
TB, TV, TH, TW, TD = 4, 3, 512, 640, 192
T_DEPTH_MIN, T_INTERVAL = 425.0, 2.5 * 1.06
T_LR, T_LREPOCHS = 1e-3, "2,3,4,5,6,7,8,9,10,11,12,13,14,15:1.2"
BF16_STEPS, F32_STEPS = 6, 2
K3_ATOL = 1e-4  # x max|plain|: the bound the JAX package holds its TPU kernel to against autodiff
PAIRED_TOL = {"f32": 2e-4, "bf16": 2e-2}  # x max|plain grad|, as tests/test_paired_sweep.py
PAIRED_GRAD_TOL = 1e-4  # x max|plain dref|: K3-terms sums dref over the planes in another order
K4_ULP_FLOOR = 1e-3  # x max|plain|: K4's ulps are counted at no smaller a value (ReLU's kink)

# the least time the card could take for a kernel's work (its bound_ms): the
# bytes it must move (each input read once, each output written once) over
# the H100 SXM's memory rate, or its operations over the peak rate for their
# type, whichever is larger
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16 tensor cores": 989e12}
NO_LIBRARY = {  # kernels that no single PyTorch call computes
    "sweep_variance": "no PyTorch call warps several views and takes their variance in one pass",
    "softmax_regression": "no PyTorch call takes the softmax, the depth expectation and the 4-window confidence "
                          "together",
    "paired_grad": "no PyTorch call computes the variance's VJP terms (2/V) g (w_v - mean) and their sum over the "
                   "planes",
}

# the eval phase: a 16-view ring acquisition at the headline resolution
EVAL_VIEWS = 16
EVAL_DEPTH_TOL = 2e-2  # x depth range: --pallas_conv0 against the module conv0, as the JAX
#                        package holds its pallas_conv0 model (tests/test_conv0_fused.py)


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


def timed_pair(kernel_fn, plain_fn, iters: int, plain_iters: int, library_fn=None):
    """Warm each, then time plain, library, kernel, kernel, library, plain in
    turns; the mean of each pair: (kernel ms, plain ms, library ms or None)."""
    import torch

    fns = [kernel_fn, plain_fn] + ([library_fn] if library_fn else [])
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    p1 = cuda_time_ms(plain_fn, plain_iters)
    l1 = cuda_time_ms(library_fn, iters) if library_fn else None
    k1 = cuda_time_ms(kernel_fn, iters)
    k2 = cuda_time_ms(kernel_fn, iters)
    l2 = cuda_time_ms(library_fn, iters) if library_fn else None
    p2 = cuda_time_ms(plain_fn, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2 if library_fn else None


def bound(nbytes: float, flops: float, peak: str) -> dict:
    """bound_ms and what sets it: ``nbytes`` at HBM_BYTES_PER_S against
    ``flops`` at PEAK_FLOPS[peak]."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[peak] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_flops": flops, "bound_peak": peak}


def sweep_grid(src_proj, ref_proj, depth_values, h: int, w: int):
    """One source view's sample grid for every (plane, ref pixel), as the
    plain warp builds it for ``F.grid_sample`` ([1, D*h, w, 2]), and the
    number of its bilinear taps that fall inside the source image (the taps
    the kernels read; the others are zeros and are skipped)."""
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.geometry.transforms import plane_sweep_coords

    px, py = plane_sweep_coords(src_proj[None], ref_proj[None], depth_values[None], h, w)
    gx, gy = px / ((w - 1) / 2.0) - 1.0, py / ((h - 1) / 2.0) - 1.0
    grid = torch.stack([gx, gy], dim=-1).reshape(1, -1, w, 2)
    x0, y0 = torch.floor(((gx + 1.0) * w - 1.0) / 2.0), torch.floor(((gy + 1.0) * h - 1.0) / 2.0)
    taps = sum(int(((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h)).sum().item())
               for dx in (0, 1) for dy in (0, 1))
    return grid, taps


def sweep_flops(proj, depth_values, h: int, w: int, c: int) -> int:
    """The variance sweep's f32 operations on this rig: per channel, 2 for
    each tap inside a source image, 3 per source view for the moments and 5
    for the reference view and the variance, at every (plane, pixel)."""
    taps = sum(sweep_grid(proj[v], proj[0], depth_values, h, w)[1] for v in range(1, proj.shape[0]))
    points = depth_values.shape[0] * h * w
    return c * (2 * taps + 3 * (proj.shape[0] - 1) * points + 5 * points)


def ring_extrinsics(cam: int, n_cams: int):
    """World-to-camera [4, 4] f32 of camera ``cam`` of an ``n_cams`` ring
    looking inward at (0, 0, RING_Z0), y up: bench.py's ``ring_projs`` and
    data/synthetic.py's ``RingRig`` (written out here: this script imports
    neither)."""
    import numpy as np

    a = 2.0 * np.pi * cam / n_cams
    eye = np.array([RING_RADIUS * np.cos(a), RING_RADIUS * np.sin(a), RING_HEIGHT])
    z = np.array([0.0, 0.0, RING_Z0]) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    E = np.eye(4)
    E[:3, :3] = np.stack([x, np.cross(z, x), z])
    E[:3, 3] = -E[:3, :3] @ eye
    return E.astype(np.float32)


def headline_rig(ref: int):
    """Feature-resolution projections [V, 4, 4] of ring camera ``ref`` and
    its 4 nearest ring neighbours, and the depth hypotheses [D]."""
    import numpy as np

    K = np.array([[W * 1.1, 0, W / 2], [0, W * 1.1, H / 2], [0, 0, 1]], np.float32) / 4.0
    projs = []
    for cam in (ref, ref + 1, ref - 1, ref + 2, ref - 2):
        P = ring_extrinsics(cam % N_CAMS, N_CAMS)
        P[:3, :4] = K @ P[:3, :4]
        projs.append(P)
    return np.stack(projs), np.linspace(DEPTH_MIN, DEPTH_MAX, D, dtype=np.float32)


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
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import build_cuda_library
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.softmax_regression import softmax_regression_cuda

    names = ("sweep_variance", "paired_grad", "warp_grad", "conv0_fused", "plane_sweep_warp")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc process each, side by side
        builds = {n: pool.submit(build_cuda_library, n) for n in names}
        t0 = time.perf_counter()
        # meanwhile the first launch compiles the Triton kernel for the headline's specialisation
        cost = torch.zeros((1, D, H // 4, W // 4), device="cuda")
        dv = torch.linspace(DEPTH_MIN, DEPTH_MAX, D, device="cuda")[None]
        softmax_regression_cuda(cost, dv)
        torch.cuda.synchronize()
        k2_s = time.perf_counter() - t0
        results = {n: f.result() for n, f in builds.items()}
    log("build", "; ".join(f"{n}.cu (nvcc sm_90a) {results[n][1]:.2f} s" for n in names)
        + f"; softmax_regression (triton) {k2_s:.2f} s")
    for n in names:
        for line in results[n][2].splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"ptxas {n}: {line.strip()}")


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
        k_ms, p_ms, _ = timed_pair(
            lambda: sweep_variance_cuda(feats_bf[0], proj[0], depth_values[0]),
            lambda: cost_volume_variance(feats_bf, proj, depth_values),
            iters=10, plain_iters=3,
        )
        k_ms32, p_ms32, _ = timed_pair(
            lambda: sweep_variance_cuda(feats[0], proj[0], depth_values[0]),
            lambda: cost_volume_variance(feats, proj, depth_values),
            iters=10, plain_iters=3,
        )
        hc = feats.shape[2:]
        k1_bound = bound(feats_bf.numel() * 2 + D * hc.numel() * 2,
                         sweep_flops(proj[0], depth_values[0], *hc), "f32")
        log("kernels", f"sweep_variance bf16->bf16: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                       f"{k1_bound['bound_ms']:.3f} ms ({k1_bound['bound_by']}); f32->f32: kernel {k_ms32:.3f} ms, "
                       f"plain {p_ms32:.3f} ms; library call: none ({NO_LIBRARY['sweep_variance']})")
        rows.append({
            "name": "sweep_variance", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/sweep_variance.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/sweep_variance.py:607",
            "max_abs_err": err_f32, "tol": SWEEP_ATOL_F32 * scale, "ms": k_ms, "plain_ms": p_ms,
            **k1_bound, "library_ms": None, "library_none": NO_LIBRARY["sweep_variance"],
            "max_abs_err_bf16": err_bf, "tol_bf16": SWEEP_ATOL_BF16 * scale_bf, "ms_f32": k_ms32,
            "plain_ms_f32": p_ms32,
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
        k_ms, p_ms, _ = timed_pair(
            lambda: softmax_regression_cuda(cost, depth_values),
            lambda: regress_depth_and_confidence(cost, depth_values),
            iters=50, plain_iters=20,
        )
        # per cost element: the max, the shift, exp, the sum and the weighted sum
        k2_bound = bound(cost.numel() * 4 + 2 * depth.numel() * 4, 5 * cost.numel(), "f32")
        log("kernels", f"softmax_regression: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                       f"{k2_bound['bound_ms']:.4f} ms ({k2_bound['bound_by']}); library call: none "
                       f"({NO_LIBRARY['softmax_regression']})")
        rows.append({
            "name": "softmax_regression", "route": "triton",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/ops/kernels/softmax_regression.py",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/softmax_regression.py:86",
            "max_abs_err": d_err, "tol": REG_DEPTH_TOL * (DEPTH_MAX - DEPTH_MIN), "ms": k_ms, "plain_ms": p_ms,
            **k2_bound, "library_ms": None, "library_none": NO_LIBRARY["softmax_regression"],
            "conf_max_abs_err": c_err, "conf_tol": REG_CONF_ATOL, "excluded_pixels": n_excl,
        })
    return rows


def phase_eval_kernels(gen) -> list[dict]:
    """K4 and K5 against their plain versions at the inference headline's
    shapes: conv0 on the bf16 cost volume [1, 192, 216, 288, 32] (also
    timing the module conv0 it replaces: cuDNN's bf16 conv, BatchNorm and
    ReLU after the permute to NCDHW), and one source view's warp in f32 and
    bf16."""
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.models.blocks import ConvBnReLU3D
    from scene_3dreconstruction_mvsnet_tpu_torch.models.mvsnet import random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import warp_src_feature
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import bf16_ulps
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.conv0_fused import (
        conv0_bn_relu_cuda, conv0_bn_relu_plain, fold_bn,
    )
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.plane_sweep_warp import plane_sweep_warp_cuda

    import torch.nn.functional as F

    dev = torch.device("cuda")
    rows = []
    with torch.inference_mode():
        conv0 = random_init_(ConvBnReLU3D(32, 8).to(dev), gen).eval()
        scale, bias = fold_bn(conv0.bn)
        x = torch.rand((1, D, H // 4, W // 4, 32), generator=gen, device=dev).to(torch.bfloat16)
        out = conv0_bn_relu_cuda(x, conv0.conv.weight, scale, bias)
        ref = conv0_bn_relu_plain(x, conv0.conv.weight, scale, bias)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        floor = K4_ULP_FLOOR * ref.float().abs().max().item()
        ulps = bf16_ulps(out, ref, floor)
        relu_share = (ref == 0).float().mean().item()
        del out, ref
        # the library yardstick: cuDNN's bf16 conv3d on the channels-last view
        # of the volume (no copy), BatchNorm folded into its weight and bias
        w_fold = (conv0.conv.weight * scale[:, None, None, None, None]).to(torch.bfloat16)
        b_fold = bias.to(torch.bfloat16)
        x_cl = x.permute(0, 4, 1, 2, 3)
        k_ms, p_ms, lib_ms = timed_pair(
            lambda: conv0_bn_relu_cuda(x, conv0.conv.weight, scale, bias),
            lambda: conv0_bn_relu_plain(x, conv0.conv.weight, scale, bias),
            iters=5, plain_iters=3,
            library_fn=lambda: torch.relu_(F.conv3d(x_cl, w_fold, b_fold, padding=1)),
        )
        module_ms = cuda_time_ms(lambda: conv0(x.permute(0, 4, 1, 2, 3).contiguous()), 5)
        B_, D_, h_, w_ = x.shape[:4]
        k4_bound = bound(x.numel() * 2 + B_ * 8 * D_ * h_ * w_ * 2,
                         2 * 32 * 8 * B_ * (3 * D_ - 2) * (3 * h_ - 2) * (3 * w_ - 2), "bf16 tensor cores")
        log("kernels", f"conv0_fused (headline, bf16): max|err| {err:.3e} = {ulps:.3f} bf16 ulp (limit 1, ulp "
                       f"floor {floor:.3e}; {100 * relu_share:.1f} % zeros); kernel {k_ms:.3f} ms, plain (f32 "
                       f"conv) {p_ms:.3f} ms, library (relu(conv3d) on the channels-last view, cuDNN bf16, BN "
                       f"folded) {lib_ms:.3f} ms, module conv0 (permute + cuDNN bf16 conv + BN + ReLU) "
                       f"{module_ms:.3f} ms; bound {k4_bound['bound_ms']:.3f} ms ({k4_bound['bound_by']})")
        if not ulps <= 1.0:
            raise AssertionError("conv0_fused kernel disagrees with its plain version")
        rows.append({
            "name": "conv0_fused", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/conv0_fused.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/conv0_fused.py:237",
            "max_abs_err": err, "max_ulp": ulps, "tol_ulp": 1.0, "ms": k_ms, "plain_ms": p_ms, **k4_bound,
            "library_ms": lib_ms, "library_call": "torch.relu_(F.conv3d(x.permute(0, 4, 1, 2, 3), w_fold, b_fold))",
            "module_ms": module_ms,
        })
        del x

        projs, dv = headline_rig(REF_CAMERAS[0])
        proj = torch.from_numpy(projs).to(dev)
        depth = torch.from_numpy(dv).to(dev)
        src32 = torch.rand((H // 4, W // 4, 32), generator=gen, device=dev)
        grid, taps = sweep_grid(proj[1], proj[0], depth, H // 4, W // 4)
        errs, times = {}, {}
        for tag, src in (("f32", src32), ("bf16", src32.to(torch.bfloat16))):
            out = plane_sweep_warp_cuda(src, proj[1], proj[0], depth)
            ref = warp_src_feature(src[None], proj[None, 1], proj[None, 0], depth[None])[0]
            torch.cuda.synchronize()
            errs[tag] = ((out.float() - ref.float()).abs().max().item(), bf16_ulps(out, ref))
            del out, ref
            # the library yardstick: grid_sample on the precomputed grid, in f32
            # (its grid takes the input's dtype, and a bf16 grid is another function)
            src_nchw = src.float().permute(2, 0, 1)[None]
            times[tag] = timed_pair(
                lambda: plane_sweep_warp_cuda(src, proj[1], proj[0], depth),
                lambda: warp_src_feature(src[None], proj[None, 1], proj[None, 0], depth[None]),
                iters=10, plain_iters=3,
                library_fn=lambda: F.grid_sample(src_nchw, grid, mode="bilinear", padding_mode="zeros",
                                                 align_corners=False),
            )
        out_elems = D * src32.numel()
        k5_bound = bound(src32.numel() * 2 + out_elems * 2, 2 * 32 * taps, "f32")
        log("kernels", f"plane_sweep_warp (headline, one view): f32 max|err| {errs['f32'][0]:.3e} (atol 0), bf16 "
                       f"max|err| {errs['bf16'][0]:.3e} = {errs['bf16'][1]:.3f} ulp (limit 1); bf16 kernel "
                       f"{times['bf16'][0]:.3f} ms, plain {times['bf16'][1]:.3f} ms, library (grid_sample, f32) "
                       f"{times['bf16'][2]:.3f} ms, bound {k5_bound['bound_ms']:.3f} ms ({k5_bound['bound_by']}); "
                       f"f32 kernel {times['f32'][0]:.3f} ms, plain {times['f32'][1]:.3f} ms")
        if errs["f32"][0] != 0.0 or errs["bf16"][1] > 1.0:
            raise AssertionError("plane_sweep_warp kernel disagrees with the plain warp")
        rows.append({
            "name": "plane_sweep_warp", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/plane_sweep_warp.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/plane_sweep_warp.py:358",
            "max_abs_err": errs["f32"][0], "tol": 0.0, "ms": times["bf16"][0], "plain_ms": times["bf16"][1],
            **k5_bound, "library_ms": times["bf16"][2],
            "library_call": "F.grid_sample(src, grid) on the precomputed grid, f32",
            "bf16_max_abs_err": errs["bf16"][0], "bf16_max_ulp": errs["bf16"][1], "bf16_tol_ulp": 1.0,
            "ms_f32": times["f32"][0], "plain_ms_f32": times["f32"][1],
        })
    return rows


class RingScene:
    """data/synthetic.py::RingRig's acquisition, written out here (this
    script imports nothing of the JAX package): the textured plane
    z = RING_Z0 + SLOPE * x seen by ``n_views`` cameras of the inward ring,
    focal 1.1 W. Renders and depth maps are exact ray-plane intersections.
    ``write_tree`` writes the unified-eval layout that
    ``make_eval_tree(root, scan, RingRig(n_views, (h, w)), ndepths)`` writes,
    with the same bytes (tests/test_torch_chip_smoke.py)."""

    SLOPE = 0.05

    def __init__(self, n_views: int, h: int, w: int) -> None:
        import numpy as np

        self.n_views, self.h, self.w = n_views, h, w
        self.K = np.array([[1.1 * w, 0.0, w / 2.0], [0.0, 1.1 * w, h / 2.0], [0.0, 0.0, 1.0]], np.float32)

    def plane_hits(self, view: int):
        """(camera-space depth, world x, world y), each [h, w] f64, at the
        integer pixel positions."""
        import numpy as np

        u, v = np.meshgrid(np.arange(self.w, dtype=np.float64), np.arange(self.h, dtype=np.float64))
        d_cam = np.stack([u, v, np.ones_like(u)], axis=-1) @ np.linalg.inv(self.K.astype(np.float64)).T
        E = ring_extrinsics(view, self.n_views).astype(np.float64)
        R = E[:3, :3]
        o = -R.T @ E[:3, 3]  # the camera centre in the world
        d_w = d_cam @ R
        s = (RING_Z0 + self.SLOPE * o[0] - o[2]) / (d_w[..., 2] - self.SLOPE * d_w[..., 0])
        return s, o[0] + s * d_w[..., 0], o[1] + s * d_w[..., 1]

    def pair_list(self) -> list[tuple[int, list[int]]]:
        """Every other camera, nearest first around the ring."""
        n = self.n_views
        return [(ref, sorted((v for v in range(n) if v != ref), key=lambda v: min((v - ref) % n, (ref - v) % n)))
                for ref in range(n)]

    def write_tree(self, root: str, scans: list[str], ndepths: int) -> None:
        """pair.txt, Cameras/XXXXXXXX_cam.txt (a depth range around the
        plane's, in ``ndepths`` intervals) and
        Rectified/<scan>/rect_CXXX_L00.png for each scan (the same images)."""
        import os

        import numpy as np

        from scene_3dreconstruction_mvsnet_tpu_torch.io import save_image_u8, write_pair_file

        hits = [self.plane_hits(v) for v in range(self.n_views)]
        depths = [hit[0].astype(np.float32) for hit in hits]
        lo, hi = float(min(d.min() for d in depths)), float(max(d.max() for d in depths))
        margin = 0.15 * (hi - lo) + 1.0
        depth_min, interval = lo - margin, (hi - lo + 2 * margin) / ndepths
        os.makedirs(os.path.join(root, "Cameras"), exist_ok=True)
        write_pair_file(os.path.join(root, "pair.txt"), self.pair_list())
        for v, (_, x_w, y_w) in enumerate(hits):
            lines = ["extrinsic", *(" ".join(f"{x:.8f}" for x in row) for row in ring_extrinsics(v, self.n_views)),
                     "", "intrinsic", *(" ".join(f"{x:.8f}" for x in row) for row in self.K),
                     "", f"{depth_min:.6f} {interval:.6f}"]
            with open(os.path.join(root, "Cameras", f"{v:0>8}_cam.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            img = _texture(0.1 * x_w, 0.1 * y_w).astype(np.float32)
            for scan in scans:
                os.makedirs(os.path.join(root, "Rectified", scan), exist_ok=True)
                save_image_u8(os.path.join(root, "Rectified", scan, f"rect_C{v:0>3}_L00.png"), np.dstack([img] * 3))


def run_eval_cli(argv: list[str], log_path: Path, stdin_text: str | None = None) -> dict:
    """``eval_cli.main(argv)`` with its output appended to ``log_path`` (and
    ``stdin_text`` as its stdin); the log's tail is printed if it fails."""
    import contextlib
    import io

    from scene_3dreconstruction_mvsnet_tpu_torch import eval_cli

    stdin = sys.stdin
    if stdin_text is not None:
        sys.stdin = io.StringIO(stdin_text)
    try:
        with open(log_path, "a") as log_file, contextlib.redirect_stdout(log_file):
            return eval_cli.main(argv)
    except BaseException:
        print(log_path.read_text()[-4000:], flush=True)
        raise
    finally:
        sys.stdin = stdin


def phase_eval(repo: Path) -> dict[str, tuple[int, int, str]]:
    """Drive eval_cli four times on a synthetic 16-view acquisition, with the
    launch counts set to 0 before each run and read after it, and hold what
    it wrote; returns K4's and K5's launch counts from their main-path runs."""
    import os
    import shutil

    import numpy as np
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.io import read_cam_file, read_pfm, read_ply
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import conv0_fused as k4
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import plane_sweep_warp as k5
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import softmax_regression as k2
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import sweep_variance as k1

    work = repo / "build" / "eval_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    root = work / "acq"
    t0 = time.perf_counter()
    RingScene(EVAL_VIEWS, H, W).write_tree(str(root), ["scan1", "scan2"], D)
    (root / "test.txt").write_text("scan1\n")
    model = random_init_(MVSNet(), torch.Generator().manual_seed(SEED))
    ckpt = work / "model.ckpt"
    torch.save({"model": {"module." + k: v for k, v in model.state_dict().items()}}, ckpt)
    tree_s = time.perf_counter() - t0

    # random weights give depth maps no view agrees with at the default
    # thresholds; loose ones keep points in the cloud
    base = ["--dataset", "dataloader_eval", "--dataset_name", "bds8", "--testpath", str(root),
            "--testlist", str(root / "test.txt"), "--loadckpt", str(ckpt), "--NviewGen", str(V),
            "--numdepth", str(D), "--interval_scale", "1.0", "--NviewFilter", "10", "--dtype", "bfloat16",
            "--img_res", str(H), str(W), "--cam_subfolder", "Cameras",
            "--img_subfolder", "Rectified/{}/rect_C{:0>3}_L00.png", "--photomask", "0.0", "--geomask", "1",
            "--condmask_pixel", "6.0", "--condmask_depth", "0.5", "--device", "cuda"]
    runs = {
        "fused": ["--pallas_conv0", "--save_ply"],
        "module": ["--skip_filter"],
        "serve": ["--pallas_conv0", "--save_ply", "--serve"],
        "debug": ["--pallas_conv0", "--skip_filter", "--debug_MVSnet", "2"],
    }
    rep = {}
    for tag, extra in runs.items():
        k1.LAUNCHES = k2.LAUNCHES = k4.LAUNCHES = k5.LAUNCHES = 0
        t0 = time.perf_counter()
        out = run_eval_cli(base + extra + ["--outdir", str(work / tag)], work / "eval_cli.log",
                           "scan1\nscan2\nquit\n" if tag == "serve" else None)
        rep[tag] = {"wall_s": time.perf_counter() - t0, "out": out,
                    "launches": {"sweep_variance": k1.LAUNCHES, "softmax_regression": k2.LAUNCHES,
                                 "conv0_fused": k4.LAUNCHES, "plane_sweep_warp": k5.LAUNCHES}}

    n = EVAL_VIEWS
    for tag in runs:
        log("eval", f"{tag}: wall {rep[tag]['wall_s']:.2f} s; kernel launches {rep[tag]['launches']}")
    expect = {"fused": (n, 0), "module": (0, 0), "serve": (2 * n, 0), "debug": (n, V - 1)}
    for tag, (k4_n, k5_n) in expect.items():
        got = rep[tag]["launches"]
        if got["conv0_fused"] != k4_n or got["plane_sweep_warp"] != k5_n or got["sweep_variance"] < (n if tag != "serve" else 2 * n):
            raise AssertionError(f"{tag}: K4 must launch {k4_n} times and K5 {k5_n}, K1 once per view: {got}")
    # the debug run is a later --pallas_conv0 stage A of the same process (its
    # first batch, which carries the dumps, is outside the steady state)
    for tag, what in (("fused", "--pallas_conv0"), ("module", "module conv0"),
                      ("debug", "--pallas_conv0, the process's second run with it")):
        a = rep[tag]["out"]["stage_a"]
        span = statistics.median(a["device_ms"][1:])
        log("eval", f"stage A s/view ({what}): {a['avg_gen_time']:.4f} (steady {a['steady_gen_time']:.4f}) over "
                    f"{a['n_views']} views; forward on the device {span:.1f} ms (median after the first), launched in "
                    f"{1e3 * a['phases']['launch'] / a['n_views']:.1f} ms per view; "
                    f"phases {', '.join(f'{k} {v:.2f} s' for k, v in a['phases'].items())}")
    b = rep["fused"]["out"]["stage_b"][0]
    log("eval", f"stage B wall: {b['wall_s']:.3f} s for {n} reference views (file reads {b['load_s']:.3f} s, "
                f"device filter + back-projection {b['filter_s']:.3f} s, masks/colours/PLY rows "
                f"{b['emit_s']:.3f} s; after stage A: {rep['fused']['out']['stage_b_wall']:.3f} s)")
    serve = rep["serve"]["out"]["serve"]
    log("eval", f"serve: {serve['views_per_s']:.3f} views/s over {serve['scans']} requests "
                f"(sustained {serve.get('views_per_s_sustained')}), stage B synchronous; its stage B per request: "
                + "; ".join(f"wall {s['wall_s']:.3f} s, device filter + back-projection {s['filter_s']:.3f} s"
                            for s in rep["serve"]["out"]["stage_b"]))

    missing = []
    for tag, scans in (("fused", ["scan1"]), ("serve", ["scan1", "scan2"]), ("module", ["scan1"]), ("debug", ["scan1"])):
        for scan in scans:
            files = [f"{kind}/{v:0>8}.pfm" for kind in ("depth_est", "confidence") for v in range(n)]
            if tag in ("fused", "serve"):
                files += [f"mask/{v:0>8}_{k}.png" for v in range(n) for k in ("photo", "geo", "final")]
            missing += [f"{tag}/{scan}/{f}" for f in files if not (work / tag / "acq" / scan / f).exists()]
    if missing:
        raise AssertionError(f"{len(missing)} eval outputs missing: {missing[:10]}")
    depth_err = max(
        float(np.abs(read_pfm(str(work / "fused/acq/scan1/depth_est" / f"{v:0>8}.pfm"))[0]
                     - read_pfm(str(work / "module/acq/scan1/depth_est" / f"{v:0>8}.pfm"))[0]).max())
        for v in range(n)
    )
    tol = EVAL_DEPTH_TOL * read_cam_file(str(root / "Cameras" / "00000000_cam.txt"))[3] * (D - 1)
    ply_points = {tag: int(read_ply(str(work / tag / "acq" / f"mvsnet{i:0>3}_l3.ply"))[0].shape[0])
                  for tag, i in (("fused", 1), ("serve", 2))}
    warp_dumps = len([f for f in os.listdir(work / "debug" / "acq" / "debug") if f.startswith("warped")])
    log("eval", f"--pallas_conv0 depth maps vs the module conv0's: max|err| {depth_err:.4f} vs {tol:.4f}; "
                f"PLY points {ply_points}; {warp_dumps} warp dumps; tree made in {tree_s:.1f} s")
    if not depth_err <= tol:
        raise AssertionError("the fused conv0's depth maps disagree with the module conv0's")
    if min(ply_points.values()) <= 0 or warp_dumps == 0:
        raise AssertionError(f"empty PLY or no warp dumps: {ply_points}, {warp_dumps}")
    shutil.rmtree(work, ignore_errors=True)
    return {"conv0_fused": (rep["fused"]["launches"]["conv0_fused"], n, "depth map"),
            "plane_sweep_warp": (rep["debug"]["launches"]["plane_sweep_warp"], V - 1, "dumped source view")}


def _texture(x, y):
    """Smooth deterministic texture over world coordinates -> [0, 1]
    (data/synthetic.py's, written out here: this script imports nothing of
    the JAX package)."""
    import numpy as np

    t = (
        0.5
        + 0.14 * np.sin(0.11 * x) * np.cos(0.07 * y)
        + 0.10 * np.sin(0.031 * (x + 2.0 * y))
        + 0.10 * np.cos(0.053 * (1.7 * x - y))
        + 0.08 * np.sin(0.61 * x + 0.2) * np.cos(0.43 * y)
        + 0.07 * np.sin(0.83 * (0.6 * x - y) + 1.1)
    )
    return np.clip(t, 0.0, 1.0)


class PlaneScene:
    """The analytic scene of data/synthetic.py::SyntheticRig at the recipe's
    size: a textured plane z = z0 + slope * x (mm) seen by pinhole cameras
    at x = baseline * cam, identity rotation; renders and depth maps are
    exact. At these values the plane lies at 624-710 mm, inside the recipe's
    425-934 mm sweep, and neighbouring cameras see 70 px of disparity."""

    FOCAL, Z0, SLOPE, BASELINE = 1150.0, 650.0, 0.15, 40.0

    def _depth(self, cam: int, scale: int):
        import numpy as np

        u, v = np.meshgrid(np.arange(0, TW, scale, dtype=np.float64), np.arange(0, TH, scale, dtype=np.float64))
        return u, v, (self.Z0 + self.SLOPE * self.BASELINE * cam) / (1.0 - self.SLOPE * (u - TW / 2) / self.FOCAL)

    def render_u8(self, cam: int):
        import numpy as np

        u, v, d = self._depth(cam, 1)
        x_w = (u - TW / 2) / self.FOCAL * d + self.BASELINE * cam
        y_w = (v - TH / 2) / self.FOCAL * d
        img = np.rint(_texture(x_w, y_w) * 255.0).astype(np.uint8)
        return np.repeat(img[..., None], 3, axis=-1)

    def depth_map(self, cam: int):
        """Depth at feature resolution (every 4th pixel), [TH/4, TW/4] f32."""
        import numpy as np

        return self._depth(cam, 4)[2].astype(np.float32)

    def proj(self, cam: int):
        """K@E at feature resolution (intrinsics / 4), [4, 4] f32."""
        import numpy as np

        K = np.array([[self.FOCAL, 0, TW / 2], [0, self.FOCAL, TH / 2], [0, 0, 1]]) / 4.0
        K[2, 2] = 1.0
        P = np.eye(4)
        P[0, 3] = -self.BASELINE * cam
        P[:3, :4] = K @ P[:3, :4]
        return P.astype(np.float32)

    def batch(self):
        """The recipe's batch: sample b has reference camera b + 1 and source
        cameras b + 2 and b (its neighbours), u8 images as the loaders pack
        them, the depth hypotheses of a DTU cam file."""
        import numpy as np

        views = [[b + 1, b + 2, b] for b in range(TB)]
        return {
            "imgs": np.stack([np.stack([self.render_u8(c) for c in vs]) for vs in views]),
            "proj_matrices": np.stack([np.stack([self.proj(c) for c in vs]) for vs in views]),
            "depth_values": np.tile((T_DEPTH_MIN + T_INTERVAL * np.arange(TD)).astype(np.float32), (TB, 1)),
            "depth": np.stack([self.depth_map(vs[0]) for vs in views]),
            "mask": np.ones((TB, TH // 4, TW // 4), np.float32),
        }


def phase_train_kernels(gen) -> list[dict]:
    """K1's emit mode (one sample), K3-terms (the recipe's batch of 4, its
    volume cotangent in the conv's NCDHW layout, as the train step hands it
    over) and K3 (the step's 8 (sample, source view) pairs in one launch)
    against their plain versions at the recipe's shapes (V=3,
    D=192, 128x160x32)."""
    import numpy as np
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.ops import (
        cost_volume_variance, warp_src_feature, warp_src_feature_grad,
    )
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import bf16_ulps
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.paired_grad import paired_grad_cuda, paired_grad_plain
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.sweep_variance import (
        homography_terms, sweep_variance_cuda,
    )
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.warp_grad import warp_grad_cuda

    dev = torch.device("cuda")
    scene = PlaneScene()
    proj = torch.from_numpy(np.stack([scene.proj(c) for c in (1, 2, 0)])[None]).to(dev)  # the batch's sample 0
    dv = (T_DEPTH_MIN + T_INTERVAL * torch.arange(TD, device=dev, dtype=torch.float32))[None]
    feats32 = torch.rand((1, TV, TH // 4, TW // 4, 32), generator=gen, device=dev)
    rows, times = [], {}
    with torch.inference_mode():
        errs = {}
        for tag, f in (("f32", feats32), ("bf16", feats32.to(torch.bfloat16))):
            var_e, warps = sweep_variance_cuda(f[0], proj[0], dv[0], emit_warps=True)
            var = sweep_variance_cuda(f[0], proj[0], dv[0])
            torch.cuda.synchronize()
            if not torch.equal(var_e, var):
                raise AssertionError(f"K1 {tag}: the variance changes when the warps are emitted")
            err, ulps = 0.0, 0.0
            for v in range(TV - 1):
                ref = warp_src_feature(f[:, v + 1], proj[:, v + 1], proj[:, 0], dv)[0].float()
                err = max(err, (warps[v].float() - ref).abs().max().item())
                ulps = max(ulps, bf16_ulps(warps[v], ref))
                del ref
            errs[tag] = (err, ulps)
            del var_e, warps, var
            times[tag] = timed_pair(
                lambda: sweep_variance_cuda(f[0], proj[0], dv[0], emit_warps=True),
                lambda: cost_volume_variance(f, proj, dv, emit_warps=True),
                iters=10, plain_iters=3,
            )[:2]
            times[tag + "_no_emit"] = cuda_time_ms(lambda: sweep_variance_cuda(f[0], proj[0], dv[0]), 10)
        log("kernels", f"sweep_variance emit (recipe): f32 warps max|err| {errs['f32'][0]:.3e} (atol 0), "
                       f"bf16 warps max|err| {errs['bf16'][0]:.3e} = {errs['bf16'][1]:.3f} ulp (limit 1 ulp); "
                       "variance identical with and without emit")
        if errs["f32"][0] != 0.0 or errs["bf16"][1] > 1.0:
            raise AssertionError("K1's emitted warps disagree with the plain warp")
        hc = feats32.shape[2:]
        emit_bound = bound(feats32.numel() * 2 + TV * TD * hc.numel() * 2, sweep_flops(proj[0], dv[0], *hc), "f32")
        log("kernels", f"sweep_variance emit (recipe): bf16 kernel {times['bf16'][0]:.3f} ms "
                       f"(no emit {times['bf16_no_emit']:.3f} ms), plain {times['bf16'][1]:.3f} ms, bound "
                       f"{emit_bound['bound_ms']:.3f} ms ({emit_bound['bound_by']}); f32 kernel "
                       f"{times['f32'][0]:.3f} ms (no emit {times['f32_no_emit']:.3f} ms), plain {times['f32'][1]:.3f} ms")
        rows.append({
            "name": "sweep_variance_emit", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/sweep_variance.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/sweep_variance.py:607",
            "max_abs_err": errs["f32"][0], "tol": 0.0, "ms": times["bf16"][0], "plain_ms": times["bf16"][1],
            **emit_bound, "library_ms": None, "library_none": NO_LIBRARY["sweep_variance"],
            "bf16_max_abs_err": errs["bf16"][0], "bf16_max_ulp": errs["bf16"][1], "bf16_tol_ulp": 1.0,
            "ms_no_emit": times["bf16_no_emit"], "ms_f32": times["f32"][0], "plain_ms_f32": times["f32"][1],
            "ms_f32_no_emit": times["f32_no_emit"],
        })
        del feats32

        # K3-terms on the recipe's batch: a bf16 volume cotangent of mixed sign in
        # the NCDHW layout the conv backward gives, the emitted warps, the features
        h_, w_ = hc[:2]
        feats = torch.rand((TB, TV, h_, w_, 32), generator=gen, device=dev).to(torch.bfloat16)
        warps = torch.rand((TB, TV - 1, TD, h_, w_, 32), generator=gen, device=dev).to(torch.bfloat16)
        g_vol = torch.randn((TB, 32, TD, h_, w_), generator=gen, device=dev).to(torch.bfloat16)
        g_vol = g_vol.permute(0, 2, 3, 4, 1)
        t, dref = paired_grad_cuda(g_vol, warps, feats)
        t_plain, dref_plain = paired_grad_plain(g_vol, warps, feats)
        torch.cuda.synchronize()
        t_equal = torch.equal(t, t_plain)
        t_err = (t - t_plain).abs().max().item()
        d_scale = dref_plain.abs().max().item()
        d_err = (dref - dref_plain).abs().max().item()
        del t_plain, dref_plain
        k_ms, p_ms, _ = timed_pair(lambda: paired_grad_cuda(g_vol, warps, feats),
                                   lambda: paired_grad_plain(g_vol, warps, feats), iters=10, plain_iters=3)
        per_value = TB * TD * hc.numel()  # (sample, plane, pixel, channel)
        terms_bytes = 2 * (g_vol.numel() + warps.numel() + feats[:, 0].numel()) + 4 * (t.numel() + dref.numel())
        # per value: g32; the view sum and the mean; dref's three; each view's two
        terms_bound = bound(terms_bytes, per_value * (1 + TV + 3 + 2 * (TV - 1)), "f32")
        log("kernels", f"paired_grad (recipe, batch {TB}): t {'equal to' if t_equal else 'NOT equal to'} the plain "
                       f"version's (max|err| {t_err:.3e}); dref max|err| {d_err:.3e} vs "
                       f"{PAIRED_GRAD_TOL * d_scale:.3e}; "
                       f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {terms_bound['bound_ms']:.3f} ms "
                       f"({terms_bound['bound_by']}); library call: none ({NO_LIBRARY['paired_grad']})")
        if not t_equal or not d_err <= PAIRED_GRAD_TOL * d_scale:
            raise AssertionError("paired_grad kernel disagrees with its plain version")
        rows.append({
            "name": "paired_grad", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/paired_grad.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/paired_sweep.py:106",
            "max_abs_err": t_err, "tol": 0.0, "ms": k_ms, "plain_ms": p_ms, **terms_bound, "library_ms": None,
            "library_none": NO_LIBRARY["paired_grad"], "dref_max_abs_err": d_err,
            "dref_tol": PAIRED_GRAD_TOL * d_scale,
        })
        del feats, warps, g_vol, dref

        # K3 on the step's (sample, source view) pairs in one launch, as the train step
        # launches it (the batch shares sample 0's rig here)
        hm = homography_terms(proj[0])  # [TV - 1, 12], as the paired sweep takes them
        pairs = t.flatten(0, 1)
        n_pairs = pairs.shape[0]
        src_views = [1 + n % (TV - 1) for n in range(n_pairs)]
        hm_step = hm[[v - 1 for v in src_views]]
        dv_step = dv.expand(n_pairs, -1).contiguous()
        src, ref_proj = proj[0, src_views], proj[0, [0] * n_pairs]
        out = warp_grad_cuda(pairs, hm_step, dv_step)
        again = warp_grad_cuda(pairs, hm_step, dv_step)
        ref = warp_src_feature_grad(pairs, src, ref_proj, dv_step)
        torch.cuda.synchronize()
        same_bits = torch.equal(out, again)
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        del out, again, ref
        # the library yardstick: grid_sample's input gradient on the precomputed grids
        grids = {v: sweep_grid(proj[0, v], proj[0, 0], dv[0], h_, w_) for v in range(1, TV)}
        grid = torch.cat([grids[v][0] for v in src_views])
        taps = sum(grids[v][1] for v in src_views)
        g_nchw = pairs.permute(0, 4, 1, 2, 3).reshape(n_pairs, 32, -1, w_)  # a view of the cotangents
        zeros = torch.zeros((n_pairs, 32, h_, w_), device=dev)
        k_ms, p_ms, lib_ms = timed_pair(
            lambda: warp_grad_cuda(pairs, hm_step, dv_step),
            lambda: warp_src_feature_grad(pairs, src, ref_proj, dv_step),
            iters=10, plain_iters=2,
            library_fn=lambda: torch.ops.aten.grid_sampler_2d_backward(g_nchw, zeros, grid, 0, 0, False,
                                                                        [True, False]),
        )
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # the wrapper's host time per call: the geometry's torch ops and the launch
        for _ in range(10):
            warp_grad_cuda(pairs, hm_step, dv_step)
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        torch.cuda.synchronize()
        k3_bound = bound(pairs.numel() * 4 + n_pairs * hc.numel() * 4, 2 * 32 * taps, "f32")
        log("kernels", f"warp_grad (recipe, the step's {n_pairs} pairs in one launch): max|err| {err:.3e} vs atol "
                       f"{K3_ATOL * scale:.3e} (max|plain| {scale:.4f}); two launches "
                       f"{'bit-identical' if same_bits else 'DIFFER'}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
                       f"library (grid_sampler_2d_backward, input gradient) {lib_ms:.3f} ms, bound "
                       f"{k3_bound['bound_ms']:.3f} ms ({k3_bound['bound_by']}); the wrapper's host time {host_ms:.3f} "
                       "ms per call")
        if not err <= K3_ATOL * scale or not same_bits:
            raise AssertionError("warp_grad kernel disagrees with its plain version or with itself")
        rows.append({
            "name": "warp_grad", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/warp_grad.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/warp_grad.py:517",
            "max_abs_err": err, "tol": K3_ATOL * scale, "ms": k_ms, "plain_ms": p_ms, **k3_bound,
            "library_ms": lib_ms, "library_call": "torch.ops.aten.grid_sampler_2d_backward(g, src, grid, ...)[0]",
            "pairs": n_pairs, "bit_identical_relaunch": same_bits, "wrapper_host_ms": host_ms,
        })
        del t, pairs
    return rows


def feature_grad(model, batch, sweep) -> "torch.Tensor":
    """d loss / d features of one train-mode forward whose step 2 is
    ``sweep(features, proj, depth_values, out_dtype)``; the rest as
    models/mvsnet.py (FeatureNet's output enters as a leaf)."""
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.models import mvsnet_loss
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import regress_depth_and_confidence

    imgs, proj, dv = batch["imgs"], batch["proj_matrices"], batch["depth_values"]
    B, V, H, W, _ = imgs.shape
    dtype = model.dtype or torch.float32
    with torch.no_grad():
        feats = model.feature(imgs.reshape(B * V, H, W, 3).to(dtype)).reshape(B, V, H // 4, W // 4, 32)
    feats.requires_grad_(True)
    cost = model.cost_regularization(sweep(feats, proj, dv, dtype))[..., 0]
    depth, _ = regress_depth_and_confidence(cost.float(), dv)
    (g,) = torch.autograd.grad(mvsnet_loss(depth, batch["depth"], batch["mask"]), feats)
    return g


class StageTimer:
    """CUDA events at the stage boundaries of one train step, recorded from
    module, tensor and optimizer hooks (no change to the step): FeatureNet,
    the sweep and CostRegNet forward, then their backward in reverse, then
    the optimizer."""

    def __init__(self, model, optimizer):
        import torch

        self.events: dict[str, torch.cuda.Event] = {}
        mark = self.mark

        def feature_pre(module, args):
            mark("feature_fwd")

        def feature_post(module, args, out):
            mark("sweep_fwd")
            out.register_hook(lambda g: mark("feature_bwd"))

        def costreg_pre(module, args):
            mark("costreg_fwd")
            args[0].register_hook(lambda g: mark("sweep_bwd_end"))

        def costreg_post(module, args, out):
            mark("head_fwd")
            out.register_hook(lambda g: mark("costreg_bwd"))

        self.handles = [
            model.feature.register_forward_pre_hook(feature_pre),
            model.feature.register_forward_hook(feature_post),
            model.cost_regularization.register_forward_pre_hook(costreg_pre),
            model.cost_regularization.register_forward_hook(costreg_post),
            optimizer.register_step_pre_hook(lambda opt, args, kwargs: mark("optimizer")),
            optimizer.register_step_post_hook(lambda opt, args, kwargs: mark("after")),
        ]

    def mark(self, name: str) -> None:
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name] = ev

    def split(self) -> dict[str, float]:
        """ms per stage, in the order the device ran them."""
        import torch

        torch.cuda.synchronize()
        for h in self.handles:
            h.remove()
        order = [("input", "start", "feature_fwd"), ("FeatureNet fwd", "feature_fwd", "sweep_fwd"),
                 ("sweep fwd (K1-emit)", "sweep_fwd", "costreg_fwd"), ("CostRegNet fwd", "costreg_fwd", "head_fwd"),
                 ("regression+loss fwd/bwd", "head_fwd", "costreg_bwd"),
                 ("CostRegNet bwd", "costreg_bwd", "sweep_bwd_end"),
                 ("sweep bwd (terms + K3)", "sweep_bwd_end", "feature_bwd"),
                 ("FeatureNet bwd", "feature_bwd", "optimizer"),
                 ("optimizer", "optimizer", "after"), ("metrics", "after", "end")]
        return {name: self.events[a].elapsed_time(self.events[b]) for name, a, b in order}


def device_busy(step, batch) -> tuple[float, float] | None:
    """(wall ms, device-busy ms) of one step under torch.profiler, the busy
    time being the union of the device activities' intervals; None when the
    profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start
    )
    if not spans:
        return None
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    ranked = sorted(prof.key_averages(), key=lambda a: -getattr(a, "self_device_time_total", 0.0))
    ours = [a for a in ranked[10:] if "paired_grad" in a.key or "warp_grad" in a.key]
    for a in ranked[:10] + ours:
        log("train", f"profiler: {getattr(a, 'self_device_time_total', 0.0) / 1e3:.3f} ms device  {a.key[:90]}")
    return wall, busy / 1e3


def phase_train(gen) -> dict[str, tuple[int, int, str]]:
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import cost_volume_variance
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import paired_grad as k3t
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import sweep_variance as k1
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import warp_grad as k3
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.paired_sweep import paired_cost_volume
    from scene_3dreconstruction_mvsnet_tpu_torch.train import make_optimizer, make_scheduler, make_train_step
    from scene_3dreconstruction_mvsnet_tpu_torch.train.state import batch_to_device

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    batch = PlaneScene().batch()
    log("train", f"analytic plane batch {tuple(batch['imgs'].shape)} u8 made in {time.perf_counter() - t0:.2f} s")
    model = random_init_(MVSNet(dtype=torch.bfloat16).to(dev), gen)
    initial = {k: v.clone() for k, v in model.state_dict().items()}

    def trainer(m):
        opt = make_optimizer(m, T_LR)
        return opt, make_train_step(m, opt, make_scheduler(opt, T_LREPOCHS, 1000), dev)

    opt16, step16 = trainer(model)
    model32 = MVSNet().to(dev)
    model32.load_state_dict(initial)
    opt32, step32 = trainer(model32)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES = k1.EMIT_LAUNCHES = k3t.LAUNCHES = k3.LAUNCHES = 0
    losses, seconds = {"bf16": [], "f32": []}, {"bf16": [], "f32": []}
    for tag, step, n in (("bf16", step16, BF16_STEPS), ("f32", step32, F32_STEPS)):
        for _ in range(n):
            t0 = time.perf_counter()
            aux = step(batch)
            losses[tag].append(float(aux["loss"]))  # waits for the step
            seconds[tag].append(time.perf_counter() - t0)
    launches = {"sweep_variance_emit": k1.EMIT_LAUNCHES, "paired_grad": k3t.LAUNCHES, "warp_grad": k3.LAUNCHES}
    if k1.LAUNCHES != k1.EMIT_LAUNCHES:
        raise AssertionError(f"a training step ran K1 without emitting the warps: {k1.LAUNCHES} launches")
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = BF16_STEPS + F32_STEPS
    log("train", f"{steps} steps at the recipe (B={TB}, V={TV}, {TH}x{TW}, D={TD}); kernel launches {launches}")
    for tag in losses:
        log("train", f"{tag} losses {', '.join(f'{x:.4f}' for x in losses[tag])}; seconds per step "
                     f"{', '.join(f'{x:.4f}' for x in seconds[tag])}")
    if not all(math.isfinite(x) for tag in losses for x in losses[tag]):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if not losses["bf16"][-1] < losses["bf16"][0]:
        raise AssertionError(f"the loss on the repeated batch did not fall over the bf16 steps: {losses['bf16']}")
    if launches != {"sweep_variance_emit": steps * TB, "paired_grad": steps, "warp_grad": steps}:
        raise AssertionError(f"a train step must launch K1-emit once per sample and K3-terms and K3 once: {launches}")
    launches = {k: (n, steps, "train step") for k, n in launches.items()}
    median = {tag: statistics.median(s[1:]) if len(s) > 1 else s[0] for tag, s in seconds.items()}
    log("train", f"median seconds per step after the first: bf16 {median['bf16']:.4f}, f32 {median['f32']:.4f}; "
                 f"peak device memory {peak:.2f} GiB")

    # the paired sweep's feature gradient against autograd through the plain sweep
    one = {k: v[:1] for k, v in batch_to_device(batch, dev).items()}
    for tag, m in (("f32", model32), ("bf16", model)):
        got = feature_grad(m, one, lambda f, p, d, dt: paired_cost_volume(f, p, d, out_dtype=dt)).float()
        want = feature_grad(m, one, lambda f, p, d, dt: cost_volume_variance(f, p, d, out_dtype=dt)).float()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        log("train", f"{tag} feature gradient, paired (K1-emit, K3-terms + K3) vs plain autograd: max|err| {err:.3e} "
                     f"vs {PAIRED_TOL[tag] * scale:.3e} (max|plain| {scale:.4e})")
        if not err <= PAIRED_TOL[tag] * scale:
            raise AssertionError(f"{tag}: the paired sweep's feature gradient disagrees with plain autograd")

    # one bf16 step's stage split and device idle share
    timer = StageTimer(model, opt16)
    timer.mark("start")
    step16(batch)
    timer.mark("end")
    split = timer.split()
    total = sum(split.values())
    log("train", "bf16 step stage split (CUDA events): " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / total:.1f} %)" for k, v in split.items()) + f"; total {total:.3f} ms")
    busy = device_busy(step16, batch)
    if busy is None:
        log("train", "device idle share: not measured (the profiler recorded no device activity)")
    else:
        wall, dev_ms = busy
        log("train", f"bf16 step under torch.profiler: {wall:.3f} ms wall, {dev_ms:.3f} ms device busy, "
                     f"idle share {100 * (1 - dev_ms / wall):.1f} %")
    return launches


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


def phase_slice(gen) -> dict[str, tuple[int, int, str]]:
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
    fused16 = MVSNet(dtype=torch.bfloat16, fused_conv0=True).to(dev)  # the eval CLI's --pallas_conv0
    fused16.load_state_dict(model32.state_dict())
    steps = {"f32": make_infer_step(model32, dev), "bf16": make_infer_step(model16, dev),
             "bf16 fused conv0": make_infer_step(fused16, dev)}

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
    launches = {k: (n, n_req, "request") for k, n in launches.items()}

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
    fused_err = max((a["depth"] - b["depth"]).abs().max().item()
                    for a, b in zip(outputs["bf16 fused conv0"], outputs["bf16"]))
    log("slice", f"bf16 fused conv0 vs bf16: depth max|err| {fused_err:.3e} vs {EVAL_DEPTH_TOL * rng_:.3e}")
    if not fused_err <= EVAL_DEPTH_TOL * rng_:
        raise AssertionError("the fused conv0's depth maps disagree with the module conv0's")

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
    rows = phase_kernels(gen) + phase_train_kernels(gen) + phase_eval_kernels(gen)
    launches = phase_slice(gen)  # K1 and K2 on the inference path
    launches.update(phase_train(gen))  # K1-emit, K3-terms and K3 on the training path
    launches.update(phase_eval(repo))  # K4 and K5 on the eval CLI's path
    for row in rows:
        n, units, unit = launches[row["name"]]
        row["launches"] = n
        row["launches_per"] = f"{n / units:g} per {unit}"

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "scene_3dreconstruction_mvsnet_tpu"))
    if leaked:
        raise AssertionError(f"the port pulled in JAX or the JAX package: {leaked[:5]}")

    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
