#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of MVSNet on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (each prints lines tagged with its name; any failure raises and the
exit code is not 0):
  1. device  the card's name, and name + power limit from nvidia-smi;
  2. build   the sweep-variance and warp-backward CUDA kernels (nvcc, sm_90a,
             one compiler process each, started together) and the
             softmax-regression Triton kernel, from the checkout's sources;
  3. kernels each kernel against its plain PyTorch version, with times from
             CUDA events: K1 and K2 at the inference headline's shapes (V=5,
             D=192, 216x288x32 features), K1's emit mode and K3 at the
             training recipe's (V=3, D=192, 128x160x32);
  4. slice   MVSNet inference at the headline configuration (864x1152 images,
             5 views of a 49-camera inward ring, 192 planes, random weights
             from a seeded generator) serving requests through
             ``make_infer_step`` in f32 and bf16; outputs are checked, the f32
             run is held against the plain path, and K1's and K2's launch
             counts must cover every request;
  5. train   MVSNet training at the train_DTU recipe (batch 4, 3 views,
             512x640, D=192, interval 2.65, Adam lr 1e-3) through the port's
             train step on an analytic plane scene: 6 bf16 steps on one
             repeated batch (the loss must fall) and 2 f32 steps, K1-emit and
             K3 launched on every step, the paired sweep's feature gradient
             held against autograd through the plain sweep, and the step's
             seconds, peak memory, stage split and device idle share.
The kernels' JSON line, then {"ok": true, "device": {...}} close the output.

There is no CPU fallback: without a CUDA device the script exits at once.
TF32 is off for the whole run, so f32 means f32 in every conv and matmul.
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
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import build_cuda_library
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.softmax_regression import softmax_regression_cuda

    names = ("sweep_variance", "warp_grad")
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
            "max_abs_err": err_f32, "tol": SWEEP_ATOL_F32 * scale, "ms": k_ms, "plain_ms": p_ms,
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
            "max_abs_err": d_err, "tol": REG_DEPTH_TOL * (DEPTH_MAX - DEPTH_MIN), "ms": k_ms, "plain_ms": p_ms,
            "conf_max_abs_err": c_err, "conf_tol": REG_CONF_ATOL, "excluded_pixels": n_excl,
        })
    return rows


def _texture(x, y):
    """Smooth deterministic texture over world coordinates -> [0, 1]
    (data/synthetic.py's, which this script cannot import: that module pulls
    in the JAX package)."""
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
    """K1's emit mode and K3 against their plain versions at the recipe's
    shapes for one sample (V=3, D=192, 128x160x32)."""
    import numpy as np
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.ops import (
        cost_volume_variance, warp_src_feature, warp_src_feature_grad,
    )
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.sweep_variance import sweep_variance_cuda
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
                out = warps[v].float()
                diff = (out - ref).abs()
                err = max(err, diff.max().item())
                # one bf16 ulp is at most 2^-7 of the value
                ulps = max(ulps, (diff / (2.0 ** -7 * torch.maximum(ref.abs(), out.abs())).clamp_min(1e-30)).max().item())
                del ref, out, diff
            errs[tag] = (err, ulps)
            del var_e, warps, var
            times[tag] = timed_pair(
                lambda: sweep_variance_cuda(f[0], proj[0], dv[0], emit_warps=True),
                lambda: cost_volume_variance(f, proj, dv, emit_warps=True),
                iters=10, plain_iters=3,
            )
            times[tag + "_no_emit"] = cuda_time_ms(lambda: sweep_variance_cuda(f[0], proj[0], dv[0]), 10)
        log("kernels", f"sweep_variance emit (recipe): f32 warps max|err| {errs['f32'][0]:.3e} (atol 0), "
                       f"bf16 warps max|err| {errs['bf16'][0]:.3e} = {errs['bf16'][1]:.3f} ulp (limit 1 ulp); "
                       "variance identical with and without emit")
        if errs["f32"][0] != 0.0 or errs["bf16"][1] > 1.0:
            raise AssertionError("K1's emitted warps disagree with the plain warp")
        log("kernels", f"sweep_variance emit (recipe): bf16 kernel {times['bf16'][0]:.3f} ms "
                       f"(no emit {times['bf16_no_emit']:.3f} ms), plain {times['bf16'][1]:.3f} ms; f32 kernel "
                       f"{times['f32'][0]:.3f} ms (no emit {times['f32_no_emit']:.3f} ms), plain {times['f32'][1]:.3f} ms")
        rows.append({
            "name": "sweep_variance_emit", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/sweep_variance.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/sweep_variance.py:607",
            "max_abs_err": errs["f32"][0], "tol": 0.0, "ms": times["bf16"][0], "plain_ms": times["bf16"][1],
            "bf16_max_abs_err": errs["bf16"][0], "bf16_max_ulp": errs["bf16"][1], "bf16_tol_ulp": 1.0,
            "ms_no_emit": times["bf16_no_emit"], "ms_f32": times["f32"][0], "plain_ms_f32": times["f32"][1],
            "ms_f32_no_emit": times["f32_no_emit"],
        })
        del feats32

        # K3 on one source view's f32 cotangent of mixed sign
        g = torch.randn((1, TD, TH // 4, TW // 4, 32), generator=gen, device=dev)
        out = warp_grad_cuda(g[0], proj[0, 1], proj[0, 0], dv[0])
        ref = warp_src_feature_grad(g, proj[:, 1], proj[:, 0], dv)[0]
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        del out, ref
        k_ms, p_ms = timed_pair(
            lambda: warp_grad_cuda(g[0], proj[0, 1], proj[0, 0], dv[0]),
            lambda: warp_src_feature_grad(g, proj[:, 1], proj[:, 0], dv),
            iters=10, plain_iters=5,
        )
        log("kernels", f"warp_grad (recipe, one view): max|err| {err:.3e} vs atol {K3_ATOL * scale:.3e} "
                       f"(max|plain| {scale:.4f}); kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        if not err <= K3_ATOL * scale:
            raise AssertionError("warp_grad kernel disagrees with its plain version")
        rows.append({
            "name": "warp_grad", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/warp_grad.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/warp_grad.py:517",
            "max_abs_err": err, "tol": K3_ATOL * scale, "ms": k_ms, "plain_ms": p_ms,
        })
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
                 ("sweep bwd (K3)", "sweep_bwd_end", "feature_bwd"), ("FeatureNet bwd", "feature_bwd", "optimizer"),
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
    top = sorted(prof.key_averages(), key=lambda a: -getattr(a, "self_device_time_total", 0.0))[:6]
    for a in top:
        log("train", f"profiler: {getattr(a, 'self_device_time_total', 0.0) / 1e3:.3f} ms device  {a.key[:90]}")
    return wall, busy / 1e3


def phase_train(gen) -> dict[str, int]:
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import cost_volume_variance
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
    k1.LAUNCHES = k1.EMIT_LAUNCHES = k3.LAUNCHES = 0
    losses, seconds = {"bf16": [], "f32": []}, {"bf16": [], "f32": []}
    for tag, step, n in (("bf16", step16, BF16_STEPS), ("f32", step32, F32_STEPS)):
        for _ in range(n):
            t0 = time.perf_counter()
            aux = step(batch)
            losses[tag].append(float(aux["loss"]))  # waits for the step
            seconds[tag].append(time.perf_counter() - t0)
    launches = {"sweep_variance_emit": k1.EMIT_LAUNCHES, "warp_grad": k3.LAUNCHES}
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
    if launches["sweep_variance_emit"] < steps * TB or launches["warp_grad"] < steps * TB * (TV - 1):
        raise AssertionError(f"K1-emit or K3 was not launched on every step: {launches}")
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
        log("train", f"{tag} feature gradient, paired (K1-emit + K3) vs plain autograd: max|err| {err:.3e} "
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
    rows = phase_kernels(gen) + phase_train_kernels(gen)
    launches = phase_slice(gen)  # K1 and K2 on the inference path
    launches.update(phase_train(gen))  # K1-emit and K3 on the training path
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
