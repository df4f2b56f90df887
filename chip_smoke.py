#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of MVSNet on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (each prints lines tagged with its name; any failure raises and the
exit code is not 0):
  1. device  the card's name, and name + power limit from nvidia-smi;
  2. build   the sweep-variance, softmax-regression, paired backward-terms,
             warp-backward, fused-conv0, single-view warp, BatchNorm and
             prob-conv CUDA kernels
             (nvcc, sm_90a, one compiler process each, started together),
             from the checkout's sources;
  3. kernels each kernel against its plain PyTorch version, with times from
             CUDA events and each kernel's own device time per launch from
             torch.profiler: K1, K2 (bf16 and f32 logits, and bf16 against
             the same values in f32 bit for bit), K4 (and the module conv0 it
             replaces) and K5 (also bit for bit against K1-emit's warps) at
             the inference headline's shapes (V=5, D=192, 216x288x32
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
             build/eval_smoke/eval_cli.log;
  7. dtu     the legacy DTU CLI (``evaldtu_cli``, evalDTU.py's f32
             configuration: 1200x1600 images cropped to 1184x1600, 5 views,
             192 planes) on an 8-view ring tree in the legacy layout that
             this script renders; every PFM, mask and the PLY are checked, K1
             and K2 must launch once per view, view 0's maps are held against
             the plain path on the card, and K1 and K2 are timed at this
             shape (the CLI's output in build/dtu_smoke/evaldtu_cli.log);
  8. train_extras  the rest of training through the port's Trainer at the
             recipe (bf16) with MVSNet(refine=True): steps with a summary and
             a --debug_MVSnet 2 dump each (the loss must fall, RefineNet must
             get gradients, K1-emit, K3-terms, K3 and K5 must launch at their
             per-step counts), the refine step's seconds, the BatchNorm
             buffers with and without the dumps, profile mode (its Chrome
             trace must name K1 and K2), and K5 at the dumps' shape;
  9. parallel  the multi-device modules: the recipe's data-parallel step on
             two ranks sharing the card over gloo (B=2 each), held against
             the single-process B=4 step (loss and gradients after step 1,
             the BatchNorm buffers equal on both ranks, K1-emit, K3-terms and
             K3 at their per-step counts on each rank); the step through
             make_sharded_train_step at world size 1 over NCCL beside the
             plain step (seconds, peak memory); make_sharded_infer over
             [cuda:0, cuda:0] on two headline requests (bf16, K4) held
             against the unsharded forward, K1, K4 and K2 once per sample;
             fuse_scan over [cuda:0, cuda:0] on the eval phase's 16 maps
             against the serial filter. Lines tagged ``parallel`` also come
             from the train phase (the --remat step: seconds, peak, K1-emit's
             count and the BatchNorm buffers against the plain step's; the
             input stage with and without prefetch_to_device) and the eval
             phase (stage A with --img_cache, cold and warm: its loader wait,
             the maps bit-equal to the uncached run's);
 10. sweep   the cost volume's depth planes split over the ranks of a sweep
             group (MVSNet(volume_sharding=...)), gloo ranks sharing the
             card: the headline request on 2 ranks (data=1 x sweep=2, 96
             planes each; f32, and bf16 with K4) held against the
             one-process forward, K1, K4 and K2 once per request on each
             rank; the recipe's step through make_sharded_train_step(mesh=)
             on 4 ranks (data=2 x sweep=2; f32 once, bf16 three times) held
             against the one-process B=4 step, K1-emit twice and K3-terms
             and K3 once per step on each rank, the parameters and
             BatchNorm buffers equal on all ranks; per rank the seconds (no
             speed figure over gloo) and the peak memory; and once in f32
             with MVSNet(remat=True) on the same 4 ranks, held to each
             rank's plain split step (loss, gradients, the BatchNorm buffers
             updated once, K1-emit again in the backward);
 11. recipes every preset of configs/workloads.json through the port's
             runner (``python -m scene_3dreconstruction_mvsnet_tpu_torch.
             recipes <preset>``), each in a process of its own, on synthetic
             trees at the preset's own image size, views, planes, interval
             scale, dtype and filter (build/recipes_smoke/; the cuts are
             printed): first K1 (bf16 features into bf16 and f32) and K2
             (bf16 logits) at 3 views and 96 planes of 128x160 features, 5
             and 192 of 216x288, the BDS8 ring's 5 and the bin ring's 4
             views with 192 planes of 128x160, and the bin tree's rig at
             batch 2; then K1-emit, K3-terms and K3 at the train_BlenderDS
             step (B=3, V=5: 12 pairs in K3's launch) and K1 and K2 at every
             new inference shape (the BDS8 test pass in bf16, the bds8 and
             bin registries' f32 at 128x160, DTU's at 144x200 in f32 and
             bf16), and the train_BlenderDS step's feature gradient, seconds,
             stage split and peak memory in this process; then train_BlenderDS
             and train_DTU for one epoch (finite losses, the checkpoint read
             back strict, launches per step and per test batch) and
             eval_BlenderDS, eval_binpicking, eval_DTU and eval_DTU with
             --dtype bfloat16 on the registries' own layouts (every file, K1
             and K2 once per view, one view held against the plain path on
             the card). These kernels' rows close the kernels' line.
 12. api     the JAX package's API ported last: geometric_filter_stack for
             every reference view of the eval phase's 16-view scan (its
             mask count equal to fuse_reference_view's; ms a view for both),
             Hourglass3d(8) in bf16 eval mode on CostRegNet's conv0 output
             at the headline ([1, 8, 192, 216, 288]; ms, peak memory), and
             in f32 on a [1, 8, 32, 64, 64] crop against the CPU within
             1e-4 x max|y|; no hand-written kernel but BatchNorm's may
             launch. It runs after phase 9;
 13. cascade CasMVSNet's per-pixel stages at its DTU test setting (5 views
             of the ring at 864x1152, 48/32/8 planes, interval ratios 4/2/1):
             K1's per-pixel build at stage 2's [5,432,576,16] with planes
             [32,432,576] and stage 3's [5,864,1152,8] with [8,864,1152] (bf16
             features, bf16 and f32 out), K2's on [1,32,432,576] and
             [1,8,864,1152] bf16 logits with per-pixel planes, each held
             against its plain version at the per-plane rows' tolerances and
             timed beside it with its bound; then a bf16 CasMVSNet through
             ``make_infer_step``, one forward under the sync debug mode
             "error" with the launch counts reset just before it (K1 and K2
             once per plane and twice per pixel, 30 BatchNorm eval launches,
             3 prob conv launches);
 14. batchnorm the BatchNorm3d + ReLU kernels at the cells' full-resolution
             8-channel volumes ([1,8,192,144,200], [1,8,8,864,1152],
             [4,8,192,128,160], bf16): the eval forward, the training
             forward and the backward, each held to the plain version (the
             forwards within 1 bf16 ulp, the statistics within 1e-5 of f64,
             dx within 2 ulps of ATen's backward, two runs bit-equal) and
             timed beside it, beside ATen's BatchNorm alone and its bound;
             then the BatchNorm launches of one forward of each model (10 a
             bf16 MVSNet eval, 9 with K4, 30 a CasMVSNet request, 30 + 30 a
             train step). The other phases' launch checks leave these
             kernels out.
 15. prob      CostRegNet's prob conv kernels (8 -> 1, 3x3x3) at the cells'
             shapes ([1,8,192,144,200], the cascade's [1,8,48,216,288],
             [1,8,32,432,576] and [1,8,8,864,1152], [4,8,192,128,160], bf16):
             the forward and the backward (input, weight and bias
             gradients), each held to the plain version (F.conv3d in f32 of
             the same inputs, TF32 off: the output and the input gradient
             within 1 bf16 ulp, the weight and bias gradients within one of
             the largest; the backward's bits repeat) and timed beside it,
             beside cuDNN's bf16 conv (the yardstick, which the port does not
             call) and its bound; then their launches in one forward of each
             model (1 a MVSNet eval, with K4 too, 3 a CasMVSNet request, 1 + 3
             a train step). The other phases' launch checks count them too.
The kernels' JSON line, then {"ok": true, "device": {...}} close the output.

There is no CPU fallback: without a CUDA device the script exits at once.
TF32 is off for the whole run, so f32 means f32 in every conv and matmul.
Nothing of JAX or of the JAX package is imported, by this script or by the
port it drives; the script fails if either was.
"""

from __future__ import annotations

import json
import math
import re
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
PAIRED_T_TOL = 1e-6  # x max|plain t| beyond V = 3: the view sum's order (tests/test_torch_kernels.py)
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
# the dtu phase: evalDTU.py's legacy configuration on an 8-view ring at its
# 1200x1600 images (cropped to 1184x1600, features 296x400)
DTU_VIEWS, DTU_H, DTU_W = 8, 1200, 1600
# the train_extras phase: Trainer steps (one an epoch) with --refine and dumps
TRAIN_EXTRAS_STEPS = 5
# the parallel phase and the --remat and prefetch lines
REMAT_STEPS, NCCL_STEPS, GLOO_STEPS = 4, 8, 3
# two ranks' global-batch step against one process's, step 1: the loss at
# GLOO_LOSS_RTOL; in f32 every gradient within GLOO_F32_GRAD_TOL x the
# largest gradient of any tensor; in bf16 within the one-process step's own
# bf16 rounding: its bf16 gradients' distance from its f32 ones (the bf16
# paths' gradients sum bf16 cotangents over 192 planes and through the
# BatchNorm backward, with cancellation)
GLOO_F32_GRAD_TOL = 1e-3
GLOO_LOSS_RTOL = {"f32": 1e-5, "bf16": 1e-3}
# the sweep phase: requests a rank serves after its warm-up, and the split
# f32 step's loss against one process's (the JAX
# package's bound for its data x sweep step, tests/test_parallel.py); the
# gradients as the parallel phase's
SWEEP_REQUESTS, SWEEP_LOSS_RTOL = 3, 1e-4
# the split step with remat against the plain split step, f32, x the largest
# |g|: the same arithmetic (the recompute's forward gives the forward's
# values), but cuDNN's backward sums in another order from run to run. On an
# H100 the remat step read 3.42e-6, 5.67e-6 and 4.43e-6 in three runs, and
# the plain step repeated (the floor, which the phase logs) 4.31e-6: the
# limit is 3.5x the largest reading
REMAT_GRAD_TOL = 2e-5
API_HOURGLASS_TOL = 1e-4  # x max|y|: f32 Hourglass3d on the card against the CPU (test_cost_reg_net_matches_jax's)
RANK_TIMEOUT_S = 600  # a spawned gloo rank's time limit
# the cascade phase: CasMVSNet at its DTU test setting (the phase's
# features are random, its planes the cascade's own from a smooth depth map)
CAS_NDEPTHS, CAS_RATIOS = (48, 32, 8), (4, 2, 1)

# the BatchNorm phase: the cells' full-resolution 8-channel volumes (dtu_request's
# conv0 and conv11, casmvs_dtu_request's stage 3, dtu_train's at B = 4)
BN_SHAPES = ((1, 8, 192, 144, 200), (1, 8, 8, 864, 1152), (4, 8, 192, 128, 160))
BN_KERNELS = ("batch_norm_eval", "batch_norm_train", "batch_norm_backward")
# the prob phase: the cells' prob inputs (dtu_request's, the cascade's three
# stages', dtu_train's at B = 4), with MVSNet's bias where the cell's model has one
PROB_SHAPES = (((1, 8, 192, 144, 200), True), ((1, 8, 48, 216, 288), False), ((1, 8, 32, 432, 576), False),
               ((1, 8, 8, 864, 1152), False), ((4, 8, 192, 128, 160), True))
PROB_KERNELS = ("prob_conv", "prob_conv_backward")
CAS_CHANNELS = (32, 16, 8)  # the FPN's stage widths
CAS_FORWARDS = 5  # timed bf16 forwards after the checked one
# the recipes phase: each preset of configs/workloads.json through the port's
# runner (recipes.py), each in a process of its own, on a synthetic tree at
# the preset's own image size, views, planes, interval scale and dtype. Cut:
# one scan a tree, one epoch, the scene lists swapped for the trees' own where
# the preset's lists name other scans, random weights from a seeded generator
RECIPE_HW = (512, 640)  # the blender layout's images (Rectified_512x640), and the DTU recipe's
RECIPE_TRAIN_VIEWS = {"train_BlenderDS": 6, "train_DTU": 5}  # 18 samples of 3 (3 of 7 lights), 35 of 4
RECIPE_EVAL_TREES = {  # preset -> (registry, ring cameras, image size, views rendered (None: all), scan)
    "eval_BlenderDS": ("bds8", 49, (512, 640), (30, 34, 46, 47), "scene_000"),
    "eval_binpicking": ("bin", 4, (512, 640), None, "binpicking"),
    "eval_DTU": ("dtu", 11, (1200, 1600), None, "scan1"),
}
RECIPE_STEPS = 3  # the train_BlenderDS step in this process, after a first one: seconds and stage split
RECIPE_TIMEOUT_S = 600  # a runner process's time limit
FUSE_RTOL = 1e-6  # depth_est_averaged, sharded against serial (tests/test_parallel.py's bound)
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


def timed_pair(kernel_fn, plain_fn, iters: int, plain_iters: int, kernel: str, library_fn=None):
    """Warm each, then time plain, library, kernel, kernel, library, plain in
    turns; the mean of each pair, and the device time per launch of the CUDA
    kernel whose name holds ``kernel`` from torch.profiler over a third run
    of the same kernel launches (the profiler's own host work would slow the
    wrappers that launch small torch ops and so inflate the events' time):
    (kernel ms, plain ms, library ms or None, device ms or None where the
    profiler saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cuda_time_ms(kernel_fn, iters)
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    device_ms = sum(spans) / 1e3 / len(spans) if spans else None
    return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2 if library_fn else None, device_ms


def fmt_ms(ms) -> str:
    return "not measured (the profiler saw no launch)" if ms is None else f"{ms:.4f} ms"


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
    data/synthetic.py's ``RingRig`` (written out here, so that the scenes
    this script renders do not come from the code it checks; the tests hold
    them equal)."""
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


def headline_rig(ref: int, hw: tuple[int, int] = (H, W)):
    """Feature-resolution projections [V, 4, 4] of ring camera ``ref`` and
    its 4 nearest ring neighbours for images of ``hw``, and the depth
    hypotheses [D]."""
    import numpy as np

    h, w = hw
    K = np.array([[w * 1.1, 0, w / 2], [0, w * 1.1, h / 2], [0, 0, 1]], np.float32) / 4.0
    projs = []
    for cam in (ref, ref + 1, ref - 1, ref + 2, ref - 2):
        P = ring_extrinsics(cam % N_CAMS, N_CAMS)
        P[:3, :4] = K @ P[:3, :4]
        projs.append(P)
    return np.stack(projs), np.linspace(DEPTH_MIN, DEPTH_MAX, D, dtype=np.float32)


def launches_of(*names: str) -> dict[str, int]:
    """The launches of the kernels ``names`` since the last reset of the
    counts, by name."""
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import launch_counts

    counts = launch_counts()
    return {name: counts[name] for name in names}


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

    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import build_cuda_library

    names = ("sweep_variance", "softmax_regression", "paired_grad", "warp_grad", "conv0_fused", "plane_sweep_warp",
             "batch_norm", "prob_conv")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc process each, side by side
        results = dict(zip(names, pool.map(build_cuda_library, names)))
    log("build", "; ".join(f"{n}.cu (nvcc sm_90a) {results[n][1]:.2f} s" for n in names)
        + f"; {time.perf_counter() - t0:.2f} s in all")
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
        k_ms, p_ms, _, dev_ms = timed_pair(
            lambda: sweep_variance_cuda(feats_bf[0], proj[0], depth_values[0]),
            lambda: cost_volume_variance(feats_bf, proj, depth_values),
            iters=10, plain_iters=3, kernel="sweep_variance_kernel",
        )
        k_ms32, p_ms32, _, dev_ms32 = timed_pair(
            lambda: sweep_variance_cuda(feats[0], proj[0], depth_values[0]),
            lambda: cost_volume_variance(feats, proj, depth_values),
            iters=10, plain_iters=3, kernel="sweep_variance_kernel",
        )
        hc = feats.shape[2:]
        k1_bound = bound(feats_bf.numel() * 2 + D * hc.numel() * 2,
                         sweep_flops(proj[0], depth_values[0], *hc), "f32")
        log("kernels", f"sweep_variance bf16->bf16: kernel {k_ms:.3f} ms (device {fmt_ms(dev_ms)}), plain "
                       f"{p_ms:.3f} ms, bound {k1_bound['bound_ms']:.3f} ms ({k1_bound['bound_by']}); f32->f32: "
                       f"kernel {k_ms32:.3f} ms (device {fmt_ms(dev_ms32)}), plain {p_ms32:.3f} ms; library call: "
                       f"none ({NO_LIBRARY['sweep_variance']})")
        rows.append({
            "name": "sweep_variance", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/sweep_variance.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/sweep_variance.py:607",
            "max_abs_err": err_f32, "tol": SWEEP_ATOL_F32 * scale, "ms": k_ms, "device_ms": dev_ms,
            "plain_ms": p_ms, **k1_bound, "library_ms": None, "library_none": NO_LIBRARY["sweep_variance"],
            "max_abs_err_bf16": err_bf, "tol_bf16": SWEEP_ATOL_BF16 * scale_bf, "ms_f32": k_ms32,
            "device_ms_f32": dev_ms32, "plain_ms_f32": p_ms32,
        })
        del feats, feats_bf

        # K2 on logits of the scale the U-Net emits: f32, and bf16 as the bf16
        # model's CostRegNet hands them over (the kernel converts as it reads)
        cost = torch.randn((1, D, H // 4, W // 4), generator=gen, device=dev) * 3.0
        cost_bf = cost.to(torch.bfloat16)
        checks, out = {}, {}
        rng_ = DEPTH_MAX - DEPTH_MIN
        for tag, x in (("f32", cost), ("bf16", cost_bf)):
            ref_depth, ref_conf = regress_depth_and_confidence(x.float(), depth_values)
            out[tag] = softmax_regression_cuda(x, depth_values)
            torch.cuda.synchronize()
            d_diff = (out[tag][0] - ref_depth).abs()
            near_int = near_integer_index(ref_depth, d_diff)
            checks[tag] = (d_diff.max().item(), (out[tag][1] - ref_conf).abs()[~near_int].max().item(),
                           int(near_int.sum().item()))
        # the bf16 logits and the same values in f32 go through the same arithmetic
        same = softmax_regression_cuda(cost_bf.float(), depth_values)
        torch.cuda.synchronize()
        bf16_bits = torch.equal(out["bf16"][0], same[0]) and torch.equal(out["bf16"][1], same[1])
        log("kernels", "softmax_regression: " + "; ".join(
            f"{tag} depth max|err| {d:.3e} vs {REG_DEPTH_TOL * rng_:.3e}, conf max|err| {c:.3e} vs "
            f"{REG_CONF_ATOL:.0e} ({n} of {cost.numel() // D} pixels excluded: expected index near an integer)"
            for tag, (d, c, n) in checks.items()) + f"; K2(bf16 x) {'equal to' if bf16_bits else 'NOT equal to'} "
            "K2(x.float()) bit for bit")
        if not all(d <= REG_DEPTH_TOL * rng_ and c <= REG_CONF_ATOL for d, c, _ in checks.values()) or not bf16_bits:
            raise AssertionError("softmax_regression kernel disagrees with its plain version")
        times = {tag: timed_pair(lambda: softmax_regression_cuda(x, depth_values),
                                 lambda: regress_depth_and_confidence(x.float(), depth_values),
                                 iters=50, plain_iters=20, kernel="softmax_regression_kernel")
                 for tag, x in (("bf16", cost_bf), ("f32", cost))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # the wrapper's host time per call: its checks, two outputs, the launch
        for _ in range(50):
            softmax_regression_cuda(cost_bf, depth_values)
        host_ms = (time.perf_counter() - t0) * 1e3 / 50
        torch.cuda.synchronize()
        # per logit: the max, the shift, exp, the sum and the weighted sum; the
        # logits read once in their dtype, the two maps written once
        maps = 2 * cost.numel() // D * 4
        k2_bound = {tag: bound(x.numel() * x.element_size() + maps, 5 * x.numel(), "f32")
                    for tag, x in (("bf16", cost_bf), ("f32", cost))}
        log("kernels", "softmax_regression: " + "; ".join(
            f"{tag} logits: kernel {times[tag][0]:.4f} ms (device {fmt_ms(times[tag][3])}), plain (with the cast to "
            f"f32) {times[tag][1]:.4f} ms, bound {k2_bound[tag]['bound_ms']:.4f} ms ({k2_bound[tag]['bound_by']})"
            for tag in times) + f"; the wrapper's host time {host_ms:.4f} ms per call; library call: none "
            f"({NO_LIBRARY['softmax_regression']})")
        rows.append({
            "name": "softmax_regression", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/softmax_regression.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/softmax_regression.py:86",
            "max_abs_err": checks["bf16"][0], "tol": REG_DEPTH_TOL * rng_, "ms": times["bf16"][0],
            "device_ms": times["bf16"][3], "plain_ms": times["bf16"][1], **k2_bound["bf16"], "library_ms": None,
            "library_none": NO_LIBRARY["softmax_regression"], "conf_max_abs_err": checks["bf16"][1],
            "conf_tol": REG_CONF_ATOL, "excluded_pixels": checks["bf16"][2], "bf16_equals_f32_bits": bf16_bits,
            "max_abs_err_f32": checks["f32"][0], "conf_max_abs_err_f32": checks["f32"][1],
            "excluded_pixels_f32": checks["f32"][2], "ms_f32": times["f32"][0], "device_ms_f32": times["f32"][3],
            "plain_ms_f32": times["f32"][1], "bound_ms_f32": k2_bound["f32"]["bound_ms"],
            "bound_by_f32": k2_bound["f32"]["bound_by"], "wrapper_host_ms": host_ms,
        })
    return rows


def phase_eval_kernels(gen) -> list[dict]:
    """K4 and K5 against their plain versions at the inference headline's
    shapes: conv0 on the bf16 cost volume [1, 192, 216, 288, 32] (also
    timing the module conv0 it replaces: cuDNN's bf16 conv, BatchNorm and
    ReLU after the permute to NCDHW), and one source view's warp in f32 and
    bf16, also held bit for bit against K1-emit's warps of the headline's
    four source views."""
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.models.blocks import ConvBnReLU3D
    from scene_3dreconstruction_mvsnet_tpu_torch.models.mvsnet import random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import warp_src_feature
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import bf16_ulps
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.conv0_fused import (
        conv0_bn_relu_cuda, conv0_bn_relu_plain, fold_bn,
    )
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.plane_sweep_warp import plane_sweep_warp_cuda
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.sweep_variance import sweep_variance_cuda

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
        k_ms, p_ms, lib_ms, dev_ms = timed_pair(
            lambda: conv0_bn_relu_cuda(x, conv0.conv.weight, scale, bias),
            lambda: conv0_bn_relu_plain(x, conv0.conv.weight, scale, bias),
            iters=5, plain_iters=3, kernel="conv0_fused_kernel",
            library_fn=lambda: torch.relu_(F.conv3d(x_cl, w_fold, b_fold, padding=1)),
        )
        module_ms = cuda_time_ms(lambda: conv0(x.permute(0, 4, 1, 2, 3).contiguous()), 5)
        B_, D_, h_, w_ = x.shape[:4]
        k4_bound = bound(x.numel() * 2 + B_ * 8 * D_ * h_ * w_ * 2,
                         2 * 32 * 8 * B_ * (3 * D_ - 2) * (3 * h_ - 2) * (3 * w_ - 2), "bf16 tensor cores")
        log("kernels", f"conv0_fused (headline, bf16): max|err| {err:.3e} = {ulps:.3f} bf16 ulp (limit 1, ulp "
                       f"floor {floor:.3e}; {100 * relu_share:.1f} % zeros); kernel {k_ms:.3f} ms (device "
                       f"{fmt_ms(dev_ms)}), plain (f32 "
                       f"conv) {p_ms:.3f} ms, library (relu(conv3d) on the channels-last view, cuDNN bf16, BN "
                       f"folded) {lib_ms:.3f} ms, module conv0 (permute + cuDNN bf16 conv + BN + ReLU) "
                       f"{module_ms:.3f} ms; bound {k4_bound['bound_ms']:.3f} ms ({k4_bound['bound_by']})")
        if not ulps <= 1.0:
            raise AssertionError("conv0_fused kernel disagrees with its plain version")
        rows.append({
            "name": "conv0_fused", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/conv0_fused.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/conv0_fused.py:237",
            "max_abs_err": err, "max_ulp": ulps, "tol_ulp": 1.0, "ms": k_ms, "device_ms": dev_ms,
            "plain_ms": p_ms, **k4_bound,
            "library_ms": lib_ms, "library_call": "torch.relu_(F.conv3d(x.permute(0, 4, 1, 2, 3), w_fold, b_fold))",
            "module_ms": module_ms,
        })
        del x

        projs, dv = headline_rig(REF_CAMERAS[0])
        proj = torch.from_numpy(projs).to(dev)
        depth = torch.from_numpy(dv).to(dev)
        feats = torch.rand((V, H // 4, W // 4, 32), generator=gen, device=dev)
        src32 = feats[1]
        grid, taps = sweep_grid(proj[1], proj[0], depth, H // 4, W // 4)
        errs, times, emit_equal = {}, {}, {}
        for tag, f in (("f32", feats), ("bf16", feats.to(torch.bfloat16))):
            src = f[1]
            out = plane_sweep_warp_cuda(src, proj[1], proj[0], depth)
            ref = warp_src_feature(src[None], proj[None, 1], proj[None, 0], depth[None])[0]
            torch.cuda.synchronize()
            errs[tag] = ((out.float() - ref.float()).abs().max().item(), bf16_ulps(out, ref))
            del out, ref
            # K1-emit's warps of the same source views, from the same features
            _, warps = sweep_variance_cuda(f, proj, depth, emit_warps=True)
            emit_equal[tag] = all(torch.equal(plane_sweep_warp_cuda(f[v], proj[v], proj[0], depth), warps[v - 1])
                                  for v in range(1, V))
            del warps
            # the library yardstick: grid_sample on the precomputed grid, in f32
            # (its grid takes the input's dtype, and a bf16 grid is another function)
            src_nchw = src.float().permute(2, 0, 1)[None]
            times[tag] = timed_pair(
                lambda: plane_sweep_warp_cuda(src, proj[1], proj[0], depth),
                lambda: warp_src_feature(src[None], proj[None, 1], proj[None, 0], depth[None]),
                iters=10, plain_iters=3, kernel="plane_sweep_warp_kernel",
                library_fn=lambda: F.grid_sample(src_nchw, grid, mode="bilinear", padding_mode="zeros",
                                                 align_corners=False),
            )
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # the wrapper's host time per call: the homography's torch ops and the launch
        for _ in range(10):
            plane_sweep_warp_cuda(src, proj[1], proj[0], depth)
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        torch.cuda.synchronize()
        out_elems = D * src32.numel()
        k5_bound = bound(src32.numel() * 2 + out_elems * 2, 2 * 32 * taps, "f32")
        log("kernels", f"plane_sweep_warp (headline, one view): f32 max|err| {errs['f32'][0]:.3e} (atol 0), bf16 "
                       f"max|err| {errs['bf16'][0]:.3e} = {errs['bf16'][1]:.3f} ulp (limit 1); K1-emit's warps of "
                       f"views 1-{V - 1} {'equal' if all(emit_equal.values()) else 'NOT equal'} bit for bit "
                       f"{emit_equal}; bf16 kernel {times['bf16'][0]:.3f} ms (device {fmt_ms(times['bf16'][3])}), "
                       f"plain {times['bf16'][1]:.3f} ms, library (grid_sample, f32) {times['bf16'][2]:.3f} ms, bound "
                       f"{k5_bound['bound_ms']:.3f} ms ({k5_bound['bound_by']}); f32 kernel {times['f32'][0]:.3f} ms "
                       f"(device {fmt_ms(times['f32'][3])}), plain {times['f32'][1]:.3f} ms; the wrapper's host time "
                       f"{host_ms:.3f} ms per call")
        if errs["f32"][0] != 0.0 or errs["bf16"][1] > 1.0 or not all(emit_equal.values()):
            raise AssertionError("plane_sweep_warp kernel disagrees with the plain warp or with K1-emit's warps")
        rows.append({
            "name": "plane_sweep_warp", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/plane_sweep_warp.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/plane_sweep_warp.py:358",
            "max_abs_err": errs["f32"][0], "tol": 0.0, "ms": times["bf16"][0], "device_ms": times["bf16"][3],
            "plain_ms": times["bf16"][1], **k5_bound, "library_ms": times["bf16"][2],
            "library_call": "F.grid_sample(src, grid) on the precomputed grid, f32",
            "bf16_max_abs_err": errs["bf16"][0], "bf16_max_ulp": errs["bf16"][1], "bf16_tol_ulp": 1.0,
            "equals_k1_emit_warps": emit_equal, "ms_f32": times["f32"][0], "device_ms_f32": times["f32"][3],
            "plain_ms_f32": times["f32"][1], "wrapper_host_ms": host_ms,
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
        """The unified-eval layout: pair.txt, Cameras/XXXXXXXX_cam.txt (a
        depth range around the plane's, in ``ndepths`` intervals) and
        Rectified/<scan>/rect_CXXX_L00.png for each scan (the same images)."""
        import os

        self._write(os.path.join(root, "Cameras"), os.path.join(root, "pair.txt"), ndepths,
                    lambda v: [os.path.join(root, "Rectified", scan, f"rect_C{v:0>3}_L00.png") for scan in scans])

    def write_legacy_tree(self, root: str, scan: str, ndepths: int) -> None:
        """The legacy DTU layout that ``make_legacy_dtu_eval_tree(root, scan,
        RingRig(n_views, (h, w)), ndepths)`` writes, with the same bytes:
        Cameras/pair.txt, Cameras/XXXXXXXX_cam.txt with the full-resolution
        intrinsics, and Rectified_raw/<scan>/rect_XXX_3_r5000.png (1-based)."""
        import os

        cams = os.path.join(root, "Cameras")
        self._write(cams, os.path.join(cams, "pair.txt"), ndepths,
                    lambda v: [os.path.join(root, "Rectified_raw", scan, f"rect_{v + 1:0>3}_3_r5000.png")])

    def write_registry_tree(self, root: str, dataset_name: str, scan: str, ndepths: int, views=None,
                            pairfile: str = "pair.txt") -> str:
        """The layout of eval.py's registry for ``dataset_name`` (eval_cli's
        DICT_CAM_SUBFOLDER and DICT_IMG_SUBFOLDER; DTU's images count from
        1) for ``views`` of the ring (default all; the cam files' depth range
        is the whole ring's), with the pair file ``pairfile`` at the tree's
        root, or two directories above it for the bin: the files that
        tests/test_torch_io.py::registry_tree writes from the JAX package's
        RingRig. Returns the tree's root (the CLI's --testpath)."""
        import os

        from scene_3dreconstruction_mvsnet_tpu_torch.eval_cli import DICT_CAM_SUBFOLDER, DICT_IMG_SUBFOLDER

        testpath = os.path.join(root, "acquisition", "rig") if dataset_name == "bin" else root
        image = DICT_IMG_SUBFOLDER[dataset_name]
        self._write(os.path.join(testpath, DICT_CAM_SUBFOLDER[dataset_name]), os.path.join(root, pairfile), ndepths,
                    lambda v: [os.path.join(testpath, image.format(scan, v + 1 if dataset_name == "dtu" else v))],
                    views)
        return testpath

    def _write(self, cam_dir: str, pair_path: str, ndepths: int, image_paths, views=None) -> None:
        """The pair file (each of ``views``, default all, with its sources
        among them), each view's cam file (the depth range of every view of
        the ring) and its render at each of ``image_paths(view)``."""
        import os

        import numpy as np

        from scene_3dreconstruction_mvsnet_tpu_torch.io import save_image_u8, write_pair_file

        views = range(self.n_views) if views is None else views
        lo, hi = math.inf, -math.inf
        for v in range(self.n_views):
            depth = self.plane_hits(v)[0].astype(np.float32)
            lo, hi = min(lo, float(depth.min())), max(hi, float(depth.max()))
        margin = 0.15 * (hi - lo) + 1.0
        depth_min, interval = lo - margin, (hi - lo + 2 * margin) / ndepths
        os.makedirs(cam_dir, exist_ok=True)
        write_pair_file(pair_path, [(ref, [v for v in srcs if v in views]) for ref, srcs in self.pair_list()
                                    if ref in views])
        for v in views:
            _, x_w, y_w = self.plane_hits(v)
            lines = ["extrinsic", *(" ".join(f"{x:.8f}" for x in row) for row in ring_extrinsics(v, self.n_views)),
                     "", "intrinsic", *(" ".join(f"{x:.8f}" for x in row) for row in self.K),
                     "", f"{depth_min:.6f} {interval:.6f}"]
            with open(os.path.join(cam_dir, f"{v:0>8}_cam.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            img = np.dstack([_texture(0.1 * x_w, 0.1 * y_w).astype(np.float32)] * 3)
            for path in image_paths(v):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                save_image_u8(path, img)


def run_cli(main, argv: list[str], log_path: Path, stdin_text: str | None = None) -> dict:
    """``main(argv)`` (a CLI of the port) with its output appended to
    ``log_path`` (and ``stdin_text`` as its stdin); the log's tail is printed
    if it fails."""
    import contextlib
    import io

    stdin = sys.stdin
    if stdin_text is not None:
        sys.stdin = io.StringIO(stdin_text)
    try:
        with open(log_path, "a") as log_file, contextlib.redirect_stdout(log_file):
            return main(argv)
    except BaseException:
        print(log_path.read_text()[-4000:], flush=True)
        raise
    finally:
        sys.stdin = stdin


def phase_eval(repo: Path) -> tuple[dict[str, tuple[int, int, str]], tuple]:
    """Drive eval_cli six times on a synthetic 16-view acquisition, with the
    launch counts set to 0 before each run and read after it, and hold what
    it wrote (stage A with --img_cache, cold and warm, bit for bit against
    the uncached run); returns K4's and K5's launch counts from their
    main-path runs, and the first run's maps, cameras and pairs for the
    parallel phase's filter."""
    import os
    import shutil

    import numpy as np
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch import eval_cli
    from scene_3dreconstruction_mvsnet_tpu_torch.io import (
        read_cam_file, read_camera_parameters, read_pair_file, read_pfm, read_ply,
    )
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import reset_launch_counts

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
        "cache_cold": ["--pallas_conv0", "--skip_filter", "--img_cache", str(work / "img_cache")],
        "cache_warm": ["--pallas_conv0", "--skip_filter", "--img_cache", str(work / "img_cache")],
    }
    rep = {}
    for tag, extra in runs.items():
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run_cli(eval_cli.main, base + extra + ["--outdir", str(work / tag)], work / "eval_cli.log",
                      "scan1\nscan2\nquit\n" if tag == "serve" else None)
        rep[tag] = {"wall_s": time.perf_counter() - t0, "out": out,
                    "launches": launches_of("sweep_variance", "softmax_regression", "conv0_fused",
                                            "plane_sweep_warp")}

    n = EVAL_VIEWS
    for tag in runs:
        log("eval", f"{tag}: wall {rep[tag]['wall_s']:.2f} s; kernel launches {rep[tag]['launches']}")
    expect = {"fused": (n, 0), "module": (0, 0), "serve": (2 * n, 0), "debug": (n, V - 1), "cache_cold": (n, 0),
              "cache_warm": (n, 0)}
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
    for tag, scans in (("fused", ["scan1"]), ("serve", ["scan1", "scan2"]), ("module", ["scan1"]), ("debug", ["scan1"]),
                       ("cache_cold", ["scan1"]), ("cache_warm", ["scan1"])):
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

    # --img_cache: the same maps, bit for bit; the loader wait cold and warm
    maps = [f"{kind}/{v:0>8}.pfm" for kind in ("depth_est", "confidence") for v in range(n)]
    same = {tag: all((work / tag / "acq/scan1" / f).read_bytes() == (work / "fused/acq/scan1" / f).read_bytes()
                     for f in maps) for tag in ("cache_cold", "cache_warm")}
    cached = len(os.listdir(work / "img_cache"))
    log("parallel", "eval: stage A loader wait (s, over 16 views): " + "; ".join(
        f"{what} {rep[tag]['out']['stage_a']['phases']['loader_wait']:.3f} (s/view steady "
        f"{rep[tag]['out']['stage_a']['steady_gen_time']:.4f})"
        for tag, what in (("fused", "uncached (the first run)"), ("debug", "uncached (a later run)"),
                          ("cache_cold", "--img_cache cold"), ("cache_warm", "--img_cache warm")))
        + f"; {cached} cache entries; maps bit-equal to the uncached run's: {same}")
    if not all(same.values()) or cached != n:
        raise AssertionError(f"--img_cache changed the depth maps or cached {cached} images, not {n}: {same}")

    # the first run's maps as its stage B reads them, for the parallel phase
    scan = work / "fused/acq/scan1"
    pair_data = read_pair_file(str(root / "pair.txt"))
    view_ids = sorted({v for r, srcs in pair_data for v in [r, *srcs]})
    cams = [read_camera_parameters(str(scan / "cams" / f"00000{v:0>3}_cam.txt")) for v in view_ids]
    scan_maps = (np.stack([read_pfm(str(scan / "depth_est" / f"{v:0>8}.pfm"))[0] for v in view_ids]),
                 np.stack([read_pfm(str(scan / "confidence" / f"{v:0>8}.pfm"))[0] for v in view_ids]),
                 np.stack([K for K, _ in cams]), np.stack([E for _, E in cams]), pair_data, view_ids)
    shutil.rmtree(work, ignore_errors=True)
    return {"conv0_fused": (rep["fused"]["launches"]["conv0_fused"], n, "depth map"),
            "plane_sweep_warp": (rep["debug"]["launches"]["plane_sweep_warp"], V - 1, "dumped source view")}, scan_maps


def phase_dtu(repo: Path, gen) -> dict:
    """Drive evaldtu_cli (``evalDTU.py``'s legacy configuration: f32, 1200 x
    1600 images cropped to 1184 x 1600, 5 views, 192 planes) on an 8-view
    legacy DTU tree of the inward ring that this script renders, with K1's
    and K2's counts set to 0 before it and read after it; check every file,
    hold view 0's maps against the plain path on the card, and time K1 and
    K2 at this shape. Returns the launch counts and the kernels' numbers for
    their rows."""
    import shutil

    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch import evaldtu_cli
    from scene_3dreconstruction_mvsnet_tpu_torch.data import find_dataset_def
    from scene_3dreconstruction_mvsnet_tpu_torch.eval.depth_gen import auto_depth_chunk
    from scene_3dreconstruction_mvsnet_tpu_torch.io import read_pfm, read_ply
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import cost_volume_variance, regress_depth_and_confidence
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import reset_launch_counts
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.softmax_regression import softmax_regression_cuda
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.sweep_variance import sweep_variance_cuda

    dev = torch.device("cuda")
    work = repo / "build" / "dtu_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    root = work / "dtu"
    t0 = time.perf_counter()
    RingScene(DTU_VIEWS, DTU_H, DTU_W).write_legacy_tree(str(root), "scan1", D)
    (root / "test.txt").write_text("scan1\n")
    model = random_init_(MVSNet(), torch.Generator().manual_seed(SEED))
    ckpt = work / "model.ckpt"
    torch.save({"model": {"module." + k: v for k, v in model.state_dict().items()}}, ckpt)
    tree_s = time.perf_counter() - t0

    # random weights: stage B's thresholds loosened as the eval phase's
    argv = ["--testpath", str(root), "--testlist", str(root / "test.txt"), "--loadckpt", str(ckpt), "--outdir",
            str(work / "out"), "--NviewGen", str(V), "--numdepth", str(D), "--interval_scale", "1.0",
            "--photomask", "0.0", "--geomask", "1", "--condmask_pixel", "6.0", "--condmask_depth", "0.5",
            "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_cli(evaldtu_cli.main, argv, work / "evaldtu_cli.log")
    wall = time.perf_counter() - t0
    launches = launches_of("sweep_variance", "softmax_regression")
    peak = torch.cuda.max_memory_allocated() / 2**30

    n = DTU_VIEWS
    scan = work / "out" / "dtu" / "scan1"
    files = [scan / f"{kind}/{v:0>8}.pfm" for kind in ("depth_est", "confidence") for v in range(n)]
    files += [scan / f"mask/{v:0>8}_{k}.png" for v in range(n) for k in ("photo", "geo", "final")]
    files.append(work / "out" / "dtu" / "mvsnet001_l3.ply")
    missing = [str(f) for f in files if not f.exists()]
    if missing:
        raise AssertionError(f"{len(missing)} evaldtu_cli outputs missing: {missing[:10]}")
    points = int(read_ply(str(files[-1]))[0].shape[0])
    a = out["stage_a"]
    steady = a["seconds"][1:]
    log("dtu", f"evaldtu_cli on {n} views of {DTU_H}x{DTU_W} (f32, V={V}, D={D}): wall {wall:.2f} s; kernel "
               f"launches {launches}; stage A s/view {', '.join(f'{x:.4f}' for x in a['seconds'])} (views 2-{n}: "
               f"mean {statistics.mean(steady):.4f}, median {statistics.median(steady):.4f}); forward's device span "
               f"{statistics.median(a['device_ms'][1:]):.1f} ms (median after the first); stage A phases "
               f"{', '.join(f'{k} {v:.3f} s' for k, v in a['phases'].items())}; stage B wall "
               f"{out['stage_b'][0]['wall_s']:.3f} s, {points} PLY points; peak device memory {peak:.2f} GiB; "
               f"tree made in {tree_s:.1f} s")
    if launches != {"sweep_variance": n, "softmax_regression": n}:
        raise AssertionError(f"K1 and K2 must launch once per evalDTU view ({n}): {launches}")
    if points <= 0:
        raise AssertionError("evaldtu_cli wrote an empty PLY")

    # view 0's maps against the plain path on the card, from the same sample
    sample = find_dataset_def("dtu_yao_eval")(str(root), str(root / "test.txt"), "test", V, D, 1.0)[0]
    h, w = sample["imgs"].shape[1] // 4, sample["imgs"].shape[2] // 4
    model = model.to(dev).eval()
    with torch.inference_mode():
        imgs = torch.from_numpy(sample["imgs"]).to(dev)
        proj = torch.from_numpy(sample["proj_matrices"]).to(dev)
        dv = torch.from_numpy(sample["depth_values"]).to(dev)
        feats = model.feature(imgs).reshape(1, V, h, w, 32)
        volume = cost_volume_variance(feats, proj[None], dv[None], depth_chunk=auto_depth_chunk((DTU_H, DTU_W), D))
        cost = model.cost_regularization(volume)[..., 0].float()
        del volume
        ref_depth, ref_conf = (t[0] for t in regress_depth_and_confidence(cost, dv[None]))
    depth = torch.from_numpy(read_pfm(str(scan / "depth_est" / "00000000.pfm"))[0].copy()).to(dev)
    conf = torch.from_numpy(read_pfm(str(scan / "confidence" / "00000000.pfm"))[0].copy()).to(dev)
    rng_ = (dv[-1] - dv[0]).item()
    d_diff = (depth - ref_depth).abs()
    # pixels whose truncated expected index may flip: the plain path's own
    # expected index (not one read back from the depth: at 400-700 mm the
    # f32 softmax's normalisation and the depth sum are each ~1e-3 of an
    # index off) within the paths' disagreement plus INT_BAND of an integer
    with torch.inference_mode():
        prob = torch.softmax(cost, dim=1)[0]
        e_idx = torch.einsum("dhw,d->hw", prob, torch.arange(D, device=dev, dtype=prob.dtype))
    near_int = (e_idx - e_idx.round()).abs() < d_diff * (D - 1) / rng_ + INT_BAND
    d_err, c_err = d_diff.max().item(), (conf - ref_conf).abs()[~near_int].max().item()
    log("dtu", f"view 0 vs the plain path on the card: depth max|err| {d_err:.3e} vs {SLICE_DEPTH_TOL * rng_:.3e}; "
               f"conf max|err| {c_err:.3e} vs {SLICE_CONF_ATOL:.0e}; {int(near_int.sum().item())} pixels excluded "
               "near an integer index")
    if not d_err <= SLICE_DEPTH_TOL * rng_ or not c_err <= SLICE_CONF_ATOL:
        raise AssertionError("evaldtu_cli's depth map disagrees with the plain path")
    del feats, cost, prob

    # K1 and K2 at this shape, f32, beside their plain versions
    rows = {}
    with torch.inference_mode():
        feats = torch.rand((V, h, w, 32), generator=gen, device=dev)
        chunk = auto_depth_chunk((DTU_H, DTU_W), D)
        k_ms, p_ms, _, dev_ms = timed_pair(
            lambda: sweep_variance_cuda(feats, proj, dv),
            lambda: cost_volume_variance(feats[None], proj[None], dv[None], depth_chunk=chunk),
            iters=5, plain_iters=2, kernel="sweep_variance_kernel",
        )
        k1_bound = bound(feats.numel() * 4 + D * h * w * 32 * 4, sweep_flops(proj, dv, h, w, 32), "f32")
        rows["sweep_variance"] = {"dtu_shape": f"[{V},{h},{w},32] f32 -> [{D},{h},{w},32] f32", "dtu_ms": k_ms,
                                  "dtu_device_ms": dev_ms, "dtu_plain_ms": p_ms,
                                  "dtu_bound_ms": k1_bound["bound_ms"], "dtu_bound_by": k1_bound["bound_by"],
                                  "launches_dtu": launches["sweep_variance"]}
        del feats
        logits = torch.randn((1, D, h, w), generator=gen, device=dev) * 3.0
        k2_ms, k2_plain, _, k2_dev = timed_pair(
            lambda: softmax_regression_cuda(logits, dv[None]),
            lambda: regress_depth_and_confidence(logits, dv[None]),
            iters=20, plain_iters=5, kernel="softmax_regression_kernel",
        )
        k2_bound = bound(logits.numel() * 4 + 2 * h * w * 4, 5 * logits.numel(), "f32")
        rows["softmax_regression"] = {"dtu_shape": f"[1,{D},{h},{w}] f32 -> 2x[1,{h},{w}] f32", "dtu_ms": k2_ms,
                                      "dtu_device_ms": k2_dev, "dtu_plain_ms": k2_plain,
                                      "dtu_bound_ms": k2_bound["bound_ms"], "dtu_bound_by": k2_bound["bound_by"],
                                      "launches_dtu": launches["softmax_regression"]}
    for name, r in rows.items():
        log("dtu", f"{name} at {r['dtu_shape']}: kernel {r['dtu_ms']:.4f} ms (device {fmt_ms(r['dtu_device_ms'])}), "
                   f"plain {r['dtu_plain_ms']:.4f} ms, bound {r['dtu_bound_ms']:.4f} ms ({r['dtu_bound_by']})")
    shutil.rmtree(work, ignore_errors=True)
    return rows


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
    """The training kernels at the train_DTU recipe's shapes (B=4, V=3,
    D=192, 128x160x32): ``train_kernel_rows`` on PlaneScene's batch."""
    import numpy as np
    import torch

    scene = PlaneScene()
    proj = np.stack([np.stack([scene.proj(c) for c in (b + 1, b + 2, b)]) for b in range(TB)])
    dv = (T_DEPTH_MIN + T_INTERVAL * np.arange(TD)).astype(np.float32)
    return train_kernel_rows(gen, torch.from_numpy(proj), torch.from_numpy(dv), TH // 4, TW // 4, "recipe")


def train_kernel_rows(gen, proj, dv, h: int, w: int, case: str) -> list[dict]:
    """K1's emit mode (sample 0, f32 and bf16 features), K3-terms (the
    batch, its volume cotangent in the conv's NCDHW layout, as the train
    step hands it over) and K3 (the step's B x (V-1) (sample, source view)
    pairs in one launch, each with its sample's rig) against their plain
    versions, for a batch of projections ``proj`` [B, V, 4, 4] at feature
    size h x w with the depth values ``dv`` [D]; the rows of the kernels'
    line, their launches still to be filled in."""
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
    proj, dv = proj.to(dev), dv.to(dev)[None]
    (B, V), D = proj.shape[:2], dv.shape[1]
    shape = f"B={B}, V={V}, D={D}, {h}x{w}x32"
    feats32 = torch.rand((1, V, h, w, 32), generator=gen, device=dev)
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
            for v in range(V - 1):
                ref = warp_src_feature(f[:, v + 1], proj[:1, v + 1], proj[:1, 0], dv)[0].float()
                err = max(err, (warps[v].float() - ref).abs().max().item())
                ulps = max(ulps, bf16_ulps(warps[v], ref))
                del ref
            errs[tag] = (err, ulps)
            del var_e, warps, var
            times[tag] = timed_pair(
                lambda: sweep_variance_cuda(f[0], proj[0], dv[0], emit_warps=True),
                lambda: cost_volume_variance(f, proj[:1], dv, emit_warps=True),
                iters=10, plain_iters=3, kernel="sweep_variance_kernel",
            )
            times[tag + "_no_emit"] = cuda_time_ms(lambda: sweep_variance_cuda(f[0], proj[0], dv[0]), 10)
        log("kernels", f"sweep_variance emit ({case}, {shape}): f32 warps max|err| {errs['f32'][0]:.3e} (atol 0), "
                       f"bf16 warps max|err| {errs['bf16'][0]:.3e} = {errs['bf16'][1]:.3f} ulp (limit 1 ulp); "
                       "variance identical with and without emit")
        if errs["f32"][0] != 0.0 or errs["bf16"][1] > 1.0:
            raise AssertionError("K1's emitted warps disagree with the plain warp")
        hc = feats32.shape[2:]
        emit_bound = bound(feats32.numel() * 2 + V * D * hc.numel() * 2, sweep_flops(proj[0], dv[0], *hc), "f32")
        log("kernels", f"sweep_variance emit ({case}): bf16 kernel {times['bf16'][0]:.3f} ms (device "
                       f"{fmt_ms(times['bf16'][3])}; no emit {times['bf16_no_emit']:.3f} ms), plain "
                       f"{times['bf16'][1]:.3f} ms, bound "
                       f"{emit_bound['bound_ms']:.3f} ms ({emit_bound['bound_by']}); f32 kernel "
                       f"{times['f32'][0]:.3f} ms (no emit {times['f32_no_emit']:.3f} ms), plain {times['f32'][1]:.3f} ms")
        rows.append({
            "name": "sweep_variance_emit", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/sweep_variance.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/sweep_variance.py:607",
            "case": case, "shape": f"[{V},{h},{w},32] bf16 -> [{D},{h},{w},32] + [{V - 1},{D},{h},{w},32] bf16",
            "max_abs_err": errs["f32"][0], "tol": 0.0, "ms": times["bf16"][0], "device_ms": times["bf16"][3],
            "plain_ms": times["bf16"][1], **emit_bound, "library_ms": None, "library_none": NO_LIBRARY["sweep_variance"],
            "bf16_max_abs_err": errs["bf16"][0], "bf16_max_ulp": errs["bf16"][1], "bf16_tol_ulp": 1.0,
            "ms_no_emit": times["bf16_no_emit"], "ms_f32": times["f32"][0], "plain_ms_f32": times["f32"][1],
            "ms_f32_no_emit": times["f32_no_emit"],
        })
        del feats32

        # K3-terms on the batch: a bf16 volume cotangent of mixed sign in the
        # NCDHW layout the conv backward gives, the emitted warps, the features
        feats = torch.rand((B, V, h, w, 32), generator=gen, device=dev).to(torch.bfloat16)
        warps = torch.rand((B, V - 1, D, h, w, 32), generator=gen, device=dev).to(torch.bfloat16)
        g_vol = torch.randn((B, 32, D, h, w), generator=gen, device=dev).to(torch.bfloat16)
        g_vol = g_vol.permute(0, 2, 3, 4, 1)
        t, dref = paired_grad_cuda(g_vol, warps, feats)
        t_plain, dref_plain = paired_grad_plain(g_vol, warps, feats)
        torch.cuda.synchronize()
        # bit for bit where the view sum has two terms, else the sum's order
        t_tol = 0.0 if V == 3 else PAIRED_T_TOL * t_plain.abs().max().item()
        t_err = (t - t_plain).abs().max().item()
        d_scale = dref_plain.abs().max().item()
        d_err = (dref - dref_plain).abs().max().item()
        del t_plain, dref_plain
        k_ms, p_ms, _, dev_ms = timed_pair(lambda: paired_grad_cuda(g_vol, warps, feats),
                                           lambda: paired_grad_plain(g_vol, warps, feats), iters=10, plain_iters=3,
                                           kernel="paired_grad_kernel")
        per_value = B * D * hc.numel()  # (sample, plane, pixel, channel)
        terms_bytes = 2 * (g_vol.numel() + warps.numel() + feats[:, 0].numel()) + 4 * (t.numel() + dref.numel())
        # per value: g32; the view sum and the mean; dref's three; each view's two
        terms_bound = bound(terms_bytes, per_value * (1 + V + 3 + 2 * (V - 1)), "f32")
        log("kernels", f"paired_grad ({case}, batch {B}, {shape}; t {t.numel():.3e} f32 values): t max|err| "
                       f"{t_err:.3e} vs {t_tol:.3e}; dref max|err| {d_err:.3e} vs {PAIRED_GRAD_TOL * d_scale:.3e}; "
                       f"kernel {k_ms:.3f} ms (device {fmt_ms(dev_ms)}), plain {p_ms:.3f} ms, bound "
                       f"{terms_bound['bound_ms']:.3f} ms "
                       f"({terms_bound['bound_by']}); library call: none ({NO_LIBRARY['paired_grad']})")
        if not t_err <= t_tol or not d_err <= PAIRED_GRAD_TOL * d_scale:
            raise AssertionError("paired_grad kernel disagrees with its plain version")
        rows.append({
            "name": "paired_grad", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/paired_grad.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/paired_sweep.py:106",
            "case": case, "shape": f"g [{B},{D},{h},{w},32] bf16, warps [{B},{V - 1},...] bf16 -> t f32, dref f32",
            "max_abs_err": t_err, "tol": t_tol, "ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms, **terms_bound,
            "library_ms": None,
            "library_none": NO_LIBRARY["paired_grad"], "dref_max_abs_err": d_err,
            "dref_tol": PAIRED_GRAD_TOL * d_scale,
        })
        del feats, warps, g_vol, dref

        # K3 on the step's (sample, source view) pairs in one launch, as the
        # train step launches it, each pair with its own sample's rig
        pairs = t.flatten(0, 1)
        n_pairs = pairs.shape[0]
        hm_step = torch.cat([homography_terms(proj[b]) for b in range(B)])  # [B * (V - 1), 12]
        src = proj[:, 1:].flatten(0, 1)
        ref_proj = proj[:, :1].expand(-1, V - 1, -1, -1).flatten(0, 1)
        dv_step = dv.expand(n_pairs, -1).contiguous()
        out = warp_grad_cuda(pairs, hm_step, dv_step)
        again = warp_grad_cuda(pairs, hm_step, dv_step)
        ref = warp_src_feature_grad(pairs, src, ref_proj, dv_step)
        torch.cuda.synchronize()
        same_bits = torch.equal(out, again)
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        del out, again, ref
        # the library yardstick: grid_sample's input gradient on the precomputed grids
        grids = [sweep_grid(src[n], ref_proj[n], dv[0], h, w) for n in range(n_pairs)]
        grid = torch.cat([g for g, _ in grids])
        taps = sum(n for _, n in grids)
        g_nchw = pairs.permute(0, 4, 1, 2, 3).reshape(n_pairs, 32, -1, w)  # a view of the cotangents
        zeros = torch.zeros((n_pairs, 32, h, w), device=dev)
        k_ms, p_ms, lib_ms, dev_ms = timed_pair(
            lambda: warp_grad_cuda(pairs, hm_step, dv_step),
            lambda: warp_src_feature_grad(pairs, src, ref_proj, dv_step),
            iters=10, plain_iters=2, kernel="warp_grad_kernel",
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
        log("kernels", f"warp_grad ({case}, the step's {n_pairs} pairs in one launch): max|err| {err:.3e} vs atol "
                       f"{K3_ATOL * scale:.3e} (max|plain| {scale:.4f}); two launches "
                       f"{'bit-identical' if same_bits else 'DIFFER'}; kernel {k_ms:.3f} ms (device "
                       f"{fmt_ms(dev_ms)}), plain {p_ms:.3f} ms, "
                       f"library (grid_sampler_2d_backward, input gradient) {lib_ms:.3f} ms, bound "
                       f"{k3_bound['bound_ms']:.3f} ms ({k3_bound['bound_by']}); the wrapper's host time {host_ms:.3f} "
                       "ms per call")
        if not err <= K3_ATOL * scale or not same_bits:
            raise AssertionError("warp_grad kernel disagrees with its plain version or with itself")
        rows.append({
            "name": "warp_grad", "route": "cuda",
            "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/warp_grad.cu",
            "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/warp_grad.py:517",
            "case": case, "shape": f"[{n_pairs},{D},{h},{w},32] f32 -> [{n_pairs},{h},{w},32] f32",
            "max_abs_err": err, "tol": K3_ATOL * scale, "ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
            **k3_bound,
            "library_ms": lib_ms, "library_call": "torch.ops.aten.grid_sampler_2d_backward(g, src, grid, ...)[0]",
            "pairs": n_pairs, "bit_identical_relaunch": same_bits, "wrapper_host_ms": host_ms,
        })
        del t, pairs, grid, g_nchw
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


def phase_train(gen) -> tuple[dict[str, tuple[int, int, str]], float, dict, dict]:
    """The recipe's steps through make_train_step, the input stage with and
    without prefetch_to_device, and the --remat step; returns the launch
    counts, the bf16 step's median seconds, the initial weights and K1-emit's
    launches per remat step."""
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.data import Loader, prefetch_to_device
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import cost_volume_variance
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import reset_launch_counts
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
    reset_launch_counts()
    losses, seconds = {"bf16": [], "f32": []}, {"bf16": [], "f32": []}
    for tag, step, n in (("bf16", step16, BF16_STEPS), ("f32", step32, F32_STEPS)):
        for _ in range(n):
            t0 = time.perf_counter()
            aux = step(batch)
            losses[tag].append(float(aux["loss"]))  # waits for the step
            seconds[tag].append(time.perf_counter() - t0)
    launches = launches_of("sweep_variance_emit", "paired_grad", "warp_grad")
    no_emit = sum(launches_of("sweep_variance", "sweep_variance_per_pixel").values())
    if no_emit:
        raise AssertionError(f"a training step ran K1 without emitting the warps: {no_emit} launches")
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

    # the input stage with the batch prefetched (pinned, copied on a side
    # stream) against the host batch, in turns
    inputs = {"host batch": [], "prefetched": []}
    for tag in ("host batch", "prefetched", "prefetched", "host batch"):
        b = batch
        if tag == "prefetched":
            ((_, b),) = list(prefetch_to_device(Loader(PlaneSamples(batch), batch_size=TB), dev))
        timer = StageTimer(model, opt16)
        timer.mark("start")
        step16(b)
        timer.mark("end")
        inputs[tag].append(timer.split()["input"])
    log("parallel", "train: the bf16 step's input stage (H2D copy and /255, CUDA events): host batch "
                    f"{', '.join(f'{x:.3f}' for x in inputs['host batch'])} ms; prefetch_to_device "
                    f"{', '.join(f'{x:.3f}' for x in inputs['prefetched'])} ms")

    # --remat: one step from the same state with and without it (the
    # BatchNorm buffers must be equal), then the step's seconds and peak
    rem = {}
    for tag in ("plain", "remat"):
        m = MVSNet(dtype=torch.bfloat16, remat=tag == "remat").to(dev)
        m.load_state_dict(initial)
        _, step = trainer(m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        secs, bufs = [], None
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            float(step(batch)["loss"])  # waits for the step
            secs.append(time.perf_counter() - t0)
            bufs = bufs or {k: v.clone() for k, v in m.state_dict().items() if "running" in k or "num_batches" in k}
        rem[tag] = {"s": statistics.median(secs[1:]), "secs": secs, "buffers": bufs,
                    "peak": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": launches_of("sweep_variance_emit", "paired_grad", "warp_grad")}
        del m, step
    same = all(torch.equal(v, rem["plain"]["buffers"][k]) for k, v in rem["remat"]["buffers"].items())
    for tag, r in rem.items():
        log("parallel", f"train: bf16 step {tag}: seconds {', '.join(f'{x:.4f}' for x in r['secs'])} (median after "
                        f"the first {r['s']:.4f}); peak device memory {r['peak']:.2f} GiB; kernel launches in "
                        f"{REMAT_STEPS} steps {r['launches']}")
    log("parallel", f"train: --remat {100 * (rem['remat']['s'] / rem['plain']['s'] - 1):+.1f} % per step, peak "
                    f"{rem['remat']['peak'] - rem['plain']['peak']:+.2f} GiB; BatchNorm buffers after one step "
                    f"{'equal' if same else 'DIFFER'} ({len(rem['plain']['buffers'])} buffers)")
    for tag, per_sample in (("plain", 1), ("remat", 2)):  # remat runs K1-emit again in the backward
        want = {"sweep_variance_emit": REMAT_STEPS * TB * per_sample, "paired_grad": REMAT_STEPS,
                "warp_grad": REMAT_STEPS}
        if rem[tag]["launches"] != want:
            raise AssertionError(f"{tag} steps launched {rem[tag]['launches']}, not {want}")
    if not same:
        raise AssertionError("a --remat step left other BatchNorm buffers than a plain step")
    extra = {"sweep_variance_emit": {"launches_remat_per_step": rem["remat"]["launches"]["sweep_variance_emit"]
                                     / REMAT_STEPS}}
    return launches, median["bf16"], initial, extra


class PlaneSamples:
    """PlaneScene's recipe batch (or ``batch``) as a dataset of its TB
    samples, for the Trainer's loader (u8 images, as pack_u8_imgs leaves
    them)."""

    def __init__(self, batch: dict | None = None) -> None:
        self.batch = PlaneScene().batch() if batch is None else batch

    def __len__(self) -> int:
        return TB

    def __getitem__(self, i: int) -> dict:
        return {k: v[i] for k, v in self.batch.items()}


def phase_train_extras(repo: Path, gen, plain_step_s: float) -> dict:
    """The rest of training through the port's Trainer at the recipe, bf16,
    with MVSNet(refine=True) on the train phase's analytic-plane samples:
    TRAIN_EXTRAS_STEPS epochs of one step each with a summary and a
    --debug_MVSnet 2 dump at every step (the counts set to 0 before and read
    after), the refine step's seconds, one step with the dumps on and one
    with them off from the same weights (the BatchNorm buffers must be
    equal), then profile mode (2 warm-up and 2 traced eval steps, the counts
    set to 0 before and read after), and K5 at the dumps' shape. Returns the
    launch counts and K5's numbers for the kernels' rows."""
    import shutil

    import numpy as np
    import torch
    import torch.nn.functional as F

    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import warp_src_feature
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import bf16_ulps
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import plane_sweep_warp as k5
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import reset_launch_counts
    from scene_3dreconstruction_mvsnet_tpu_torch.train.loop import Trainer

    dev = torch.device("cuda")
    work = repo / "build" / "train_extras"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    samples = PlaneSamples()
    init = random_init_(MVSNet(refine=True, dtype=torch.bfloat16).to(dev), gen).state_dict()

    def trainer(tag: str, epochs: int, debug: int) -> Trainer:
        model = MVSNet(refine=True, dtype=torch.bfloat16)
        model.load_state_dict(init)
        return Trainer(model, samples, samples, logdir=str(work / tag), epochs=epochs, lr=T_LR, lrepochs=T_LREPOCHS,
                       batch_size=TB, summary_freq=1, save_freq=1000, seed=SEED, num_workers=0, debug_mvsnet=debug,
                       device=dev)

    steps = TRAIN_EXTRAS_STEPS
    main = trainer("dumps", steps, 2)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(lambda _: main.train(), [], work / "trainer.log")
    wall = time.perf_counter() - t0
    launches = launches_of("sweep_variance_emit", "paired_grad", "warp_grad", "plane_sweep_warp")
    launches.update({f"{k} (eval)": n for k, n in launches_of("sweep_variance", "softmax_regression").items()})
    with open(work / "dumps" / "scalars.jsonl") as f:
        losses = [r["loss"] for r in map(json.loads, f) if r["mode"] == "train"]
    refine_grads = {n: p.grad.abs().max().item() for n, p in main.model.named_parameters()
                    if n.startswith("refine_network.")}
    dumps = [len(list((work / "dumps" / "debug_train" / f"step{i:06d}" / "debug").glob("warped_*.png")))
             for i in range(steps)]
    log("train_extras", f"Trainer, MVSNet(refine=True) bf16 at the recipe: {steps} steps with a summary and a "
                        f"--debug_MVSnet 2 dump each in {wall:.2f} s; kernel launches {launches}; losses "
                        f"{', '.join(f'{x:.4f}' for x in losses)}; warp dumps per step {dumps}; RefineNet's "
                        f"largest |grad| per tensor {min(refine_grads.values()):.3e} to "
                        f"{max(refine_grads.values()):.3e}")
    want = {"sweep_variance_emit": steps * TB, "paired_grad": steps, "warp_grad": steps,
            "plane_sweep_warp": steps * (TV - 1), "sweep_variance (eval)": steps * TB,
            "softmax_regression (eval)": steps}
    if launches != want:
        raise AssertionError(f"the Trainer's steps, dumps and test passes launched {launches}, not {want}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps or not losses[-1] < losses[0]:
        raise AssertionError(f"the refine loss on the repeated batch did not fall: {losses}")
    if not min(refine_grads.values()) > 0:
        raise AssertionError(f"a RefineNet parameter got no gradient: {refine_grads}")
    if dumps != [(TV - 1) * 4 * 4] * steps:
        raise AssertionError(f"each step must dump 4 planes x 4 channels of each source view: {dumps}")

    # the refine step's seconds: the Trainer's own train step on the batch
    seconds = []
    for _ in range(4):
        t0 = time.perf_counter()
        float(main.train_step(samples.batch)["loss"])  # waits for the step
        seconds.append(time.perf_counter() - t0)
    refine_s = statistics.median(seconds[1:])
    log("train_extras", f"bf16 step with --refine: seconds {', '.join(f'{x:.4f}' for x in seconds)} (median after "
                        f"the first {refine_s:.4f}) against the train phase's plain step {plain_step_s:.4f} "
                        f"({100 * (refine_s / plain_step_s - 1):+.1f} %)")

    # one step with the dumps on and one with them off, from the same weights
    stats = {}
    for tag, debug in (("one_dumps", 2), ("one_plain", 0)):
        t = trainer(tag, 1, debug)
        run_cli(lambda _: t.train(), [], work / "trainer.log")
        stats[tag] = {k: v for k, v in t.model.state_dict().items() if "running" in k or "num_batches" in k}
    same = all(torch.equal(v, stats["one_plain"][k]) for k, v in stats["one_dumps"].items())
    log("train_extras", f"BatchNorm buffers after one step with the dumps and one without: "
                        f"{'equal' if same else 'DIFFER'} ({len(stats['one_plain'])} buffers)")
    if not same:
        raise AssertionError("the train-time dumps changed the BatchNorm buffers")

    # profile mode: eval steps traced into a Chrome trace
    reset_launch_counts()
    t0 = time.perf_counter()
    trace = run_cli(lambda _: main.profile(warmup_iters=2, profile_iters=2), [], work / "trainer.log")
    prof_s = time.perf_counter() - t0
    prof_launches = launches_of("sweep_variance", "softmax_regression")
    text = Path(trace).read_text()
    named = {k: k in text for k in ("sweep_variance_kernel", "softmax_regression_kernel")}
    log("train_extras", f"profile mode: 2 warm-up + 2 traced eval steps in {prof_s:.2f} s; kernel launches "
                        f"{prof_launches}; trace {len(text) / 1e6:.1f} MB names {named}")
    if prof_launches != {"sweep_variance": 4 * TB, "softmax_regression": 4} or not all(named.values()):
        raise AssertionError(f"profile mode: K1 once per sample and K2 once per eval step, both in the trace: "
                             f"{prof_launches}, {named}")

    # K5 at the dumps' shape: one source view of the recipe
    scene = PlaneScene()
    proj = torch.from_numpy(np.stack([scene.proj(c) for c in (1, 2, 0)])).to(dev)
    dv = T_DEPTH_MIN + T_INTERVAL * torch.arange(TD, device=dev, dtype=torch.float32)
    h, w = TH // 4, TW // 4
    with torch.inference_mode():
        src = torch.rand((h, w, 32), generator=gen, device=dev).to(torch.bfloat16)
        out = k5.plane_sweep_warp_cuda(src, proj[1], proj[0], dv)
        ulps = bf16_ulps(out, warp_src_feature(src[None], proj[None, 1], proj[None, 0], dv[None])[0])
        grid, taps = sweep_grid(proj[1], proj[0], dv, h, w)
        src_nchw = src.float().permute(2, 0, 1)[None]
        k_ms, p_ms, lib_ms, dev_ms = timed_pair(
            lambda: k5.plane_sweep_warp_cuda(src, proj[1], proj[0], dv),
            lambda: warp_src_feature(src[None], proj[None, 1], proj[None, 0], dv[None]),
            iters=10, plain_iters=3, kernel="plane_sweep_warp_kernel",
            library_fn=lambda: F.grid_sample(src_nchw, grid, mode="bilinear", padding_mode="zeros",
                                             align_corners=False),
        )
    k5_bound = bound(src.numel() * 2 + TD * src.numel() * 2, 2 * 32 * taps, "f32")
    log("train_extras", f"plane_sweep_warp (recipe, one view, bf16): {ulps:.3f} ulp from the plain warp (limit 1); "
                        f"kernel {k_ms:.3f} ms (device {fmt_ms(dev_ms)}), plain {p_ms:.3f} ms, library (grid_sample, "
                        f"f32) {lib_ms:.3f} ms, bound {k5_bound['bound_ms']:.3f} ms ({k5_bound['bound_by']})")
    if ulps > 1.0:
        raise AssertionError("plane_sweep_warp disagrees with the plain warp at the recipe's shape")
    shutil.rmtree(work, ignore_errors=True)
    return {
        "plane_sweep_warp": {"recipe_shape": f"[{h},{w},32] bf16 -> [{TD},{h},{w},32] bf16", "recipe_ms": k_ms,
                             "recipe_device_ms": dev_ms, "recipe_plain_ms": p_ms, "recipe_library_ms": lib_ms,
                             "recipe_bound_ms": k5_bound["bound_ms"], "recipe_bound_by": k5_bound["bound_by"],
                             "recipe_max_ulp": ulps, "launches_train_dumps": launches["plane_sweep_warp"]},
        **{k: {"launches_refine_train": launches[k]} for k in ("sweep_variance_emit", "paired_grad", "warp_grad")},
        "softmax_regression": {"launches_profile": prof_launches["softmax_regression"]},
    }


def _gloo_rank(rank: int, port: int, work: str) -> None:
    """One of the parallel phase's two ranks, sharing cuda:0 over gloo: the
    recipe's step through make_sharded_train_step (SGD) on this rank's rows
    of the batch in ``work``, once in f32 and GLOO_STEPS times in bf16;
    writes each first step's loss and gradients, the bf16 steps' seconds and
    launch counts, and the BatchNorm buffers after them to
    ``work/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import reset_launch_counts
    from scene_3dreconstruction_mvsnet_tpu_torch.parallel import initialize_multihost, make_sharded_train_step
    from scene_3dreconstruction_mvsnet_tpu_torch.train import make_scheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo", local_rank=0, timeout_s=300)
    dev = torch.device("cuda", 0)
    task = torch.load(Path(work) / "task.pt", weights_only=False)
    out = {"seconds": [], "launches": []}
    for tag, dtype, steps in (("f32", None, 1), ("bf16", torch.bfloat16, GLOO_STEPS)):
        model = MVSNet(dtype=dtype).to(dev)
        model.load_state_dict(task["state"])
        opt = torch.optim.SGD(model.parameters(), lr=T_LR)
        step, shard_fn = make_sharded_train_step(model, opt, make_scheduler(opt, T_LREPOCHS, 1000), dev)
        rows = shard_fn(task["batch"])
        for i in range(steps):
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(rows)["loss"])  # waits for the step
            if tag == "bf16":
                out["seconds"].append(time.perf_counter() - t0)
                out["launches"].append(launches_of("sweep_variance_emit", "paired_grad", "warp_grad"))
            if i == 0:
                out[tag] = {"loss": loss, "grads": {n: p.grad.float().cpu() for n, p in model.named_parameters()}}
    out["buffers"] = {k: v.cpu() for k, v in model.state_dict().items() if "running" in k or "num_batches" in k}
    out["rows"] = int(rows["imgs"].shape[0])
    torch.save(out, Path(work) / f"rank{rank}.pt")
    dist.destroy_process_group()


def grad_err(got: dict, ref: dict) -> tuple[float, str, dict]:
    """max|got - ref| over the tensors in units of the largest |ref|, the
    tensor where it is reached, and each tensor's error in its own max."""
    largest = max(g.abs().max().item() for g in ref.values())
    errs = {n: (got[n] - g).abs().max().item() for n, g in ref.items()}
    worst = max(errs, key=errs.get)
    return errs[worst] / largest, worst, {n: errs[n] / max(g.abs().max().item(), 1e-30) for n, g in ref.items()}


def run_ranks(target, world: int, work: Path, *args) -> None:
    """Start ``target(rank, port, work, *args)`` in ``world`` spawned
    processes (they share cuda:0 over gloo) and wait for them; a rank that
    fails or is still running after RANK_TIMEOUT_S fails the phase."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, port, str(work), *args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + RANK_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"a gloo rank of {target.__name__} failed: exit codes {[p.exitcode for p in procs]}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_parallel(repo: Path, gen, initial: dict, plain_step_s: float, scan_maps: tuple) -> dict:
    """The multi-device modules on the one card: the data-parallel step on two
    gloo ranks against one process, at world size 1 over NCCL beside the
    plain step, make_sharded_infer and fuse_scan over [cuda:0, cuda:0]
    against their unsharded runs; the counts set to 0 before each run and
    read after it. Returns the launch counts for the kernels' rows."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from scene_3dreconstruction_mvsnet_tpu_torch.eval.filtering import fuse_scan
    from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import reset_launch_counts
    from scene_3dreconstruction_mvsnet_tpu_torch.parallel import (
        initialize_multihost, make_sharded_infer, make_sharded_train_step,
    )
    from scene_3dreconstruction_mvsnet_tpu_torch.train import make_optimizer, make_scheduler, make_train_step

    dev = torch.device("cuda", 0)
    work = repo / "build" / "parallel_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    batch = PlaneScene().batch()
    extra: dict = {}

    # two ranks on the one card (gloo), B = 2 each, against one process at B = 4
    torch.save({"state": initial, "batch": batch}, work / "task.pt")
    want = {}
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        ref = MVSNet(dtype=dtype).to(dev)
        ref.load_state_dict(initial)
        opt = torch.optim.SGD(ref.parameters(), lr=T_LR)
        loss = float(make_train_step(ref, opt, make_scheduler(opt, T_LREPOCHS, 1000), dev)(batch)["loss"])
        want[tag] = {"loss": loss, "grads": {n: p.grad.float().cpu() for n, p in ref.named_parameters()}}
        del ref, opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_ranks(_gloo_rank, 2, work)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]

    floor, floor_at, _ = grad_err(want["bf16"]["grads"], want["f32"]["grads"])
    limits = {"f32": GLOO_F32_GRAD_TOL, "bf16": floor}
    agree = True
    for tag, w in want.items():
        got = ranks[0][tag]
        err, at, own = grad_err(got["grads"], w["grads"])
        loss_off = abs(got["loss"] - w["loss"]) / abs(w["loss"])
        log("parallel", f"gloo, 2 ranks vs one process at B={TB} ({tag}, SGD), step 1: loss {got['loss']:.6f} vs "
                        f"{w['loss']:.6f} (rtol {loss_off:.2e}, limit {GLOO_LOSS_RTOL[tag]:.0e}); gradients max|err| "
                        f"{err:.2e} x the largest |g| (at {at}; limit {limits[tag]:.2e}"
                        + (f", the one-process bf16 step's distance from its f32 step, at {floor_at})" if tag == "bf16"
                           else ")") + "; in each tensor's own max|g|, the worst: "
                        + ", ".join(f"{n} {own[n]:.2e}" for n in sorted(own, key=own.get)[-3:]))
        agree = agree and loss_off <= GLOO_LOSS_RTOL[tag] and err <= limits[tag]
    same_bufs = all(torch.equal(v, ranks[1]["buffers"][k]) for k, v in ranks[0]["buffers"].items())
    per_step = {"sweep_variance_emit": TB // 2, "paired_grad": 1, "warp_grad": 1}
    for r, out in enumerate(ranks):
        log("parallel", f"gloo rank {r} of 2 on cuda:0 ({out['rows']} rows of B={TB}, bf16): seconds per step "
                        f"{', '.join(f'{x:.4f}' for x in out['seconds'])}; launches per step {out['launches']}")
    log("parallel", f"gloo: BatchNorm buffers after {GLOO_STEPS} bf16 steps {'equal' if same_bufs else 'DIFFER'} on "
                    f"both ranks; {time.perf_counter() - t0:.1f} s with the processes' start")
    if not agree or not same_bufs:
        raise AssertionError("the two-rank step disagrees with the single-process step or across its ranks")
    if any(c != per_step for out in ranks for c in out["launches"]):
        raise AssertionError(f"each rank's step must launch {per_step}")
    extra["sweep_variance_emit"] = {"launches_gloo_per_rank_step": per_step["sweep_variance_emit"]}

    # world size 1 over NCCL at B = 4 (Adam, the recipe), the plain step in turns
    initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl", local_rank=0, timeout_s=300)
    secs, peaks = {"plain": [], "nccl": []}, {}
    for tag in ("plain", "nccl", "plain"):
        m = MVSNet(dtype=torch.bfloat16).to(dev)
        m.load_state_dict(initial)
        o = make_optimizer(m, T_LR)
        sched = make_scheduler(o, T_LREPOCHS, 1000)
        step = make_train_step(m, o, sched, dev) if tag == "plain" else make_sharded_train_step(m, o, sched, dev)[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        n = NCCL_STEPS if tag == "nccl" else NCCL_STEPS // 2
        for _ in range(n):
            t0 = time.perf_counter()
            float(step(batch)["loss"])  # waits for the step
            secs[tag].append(time.perf_counter() - t0)
        peaks[tag] = torch.cuda.max_memory_allocated() / 2**30
        got = launches_of("sweep_variance_emit", "paired_grad", "warp_grad")
        if got != {"sweep_variance_emit": n * TB, "paired_grad": n, "warp_grad": n}:
            raise AssertionError(f"{tag} steps launched {got}")
        if tag == "nccl":
            extra["paired_grad"] = {"launches_nccl_world1": got["paired_grad"]}
        del m, o, step
    dist.destroy_process_group()
    med = {tag: statistics.median(x[1:] if tag == "nccl" else x[1:4] + x[5:]) for tag, x in secs.items()}
    log("parallel", f"NCCL, world size 1, make_sharded_train_step (bf16, B={TB}): seconds per step "
                    f"{', '.join(f'{x:.4f}' for x in secs['nccl'])} (median after the first {med['nccl']:.4f}); "
                    f"the plain step in turns {med['plain']:.4f} ({100 * (med['nccl'] / med['plain'] - 1):+.1f} %), "
                    f"the train phase's {plain_step_s:.4f}; peak device memory {peaks['nccl']:.2f} GiB (plain "
                    f"{peaks['plain']:.2f} GiB)")

    # sharded stage A: two headline requests over [cuda:0, cuda:0] (bf16, K4)
    host_gen = torch.Generator().manual_seed(SEED + 1)
    rigs = [headline_rig(ref) for ref in REF_CAMERAS[:2]]
    imgs = torch.randint(0, 256, (2, V, H, W, 3), generator=host_gen, dtype=torch.uint8)
    projs = torch.from_numpy(np.stack([p for p, _ in rigs]))
    dvs = torch.from_numpy(np.stack([d for _, d in rigs]))
    model = random_init_(MVSNet(dtype=torch.bfloat16, fused_conv0=True).to(dev), gen)
    whole_model = MVSNet(dtype=torch.bfloat16, fused_conv0=True)
    whole_model.load_state_dict(model.state_dict())
    whole = make_infer_step(whole_model, dev)
    sharded = make_sharded_infer(model, [dev, dev])
    want = whole(imgs, projs, dvs)
    torch.cuda.synchronize()
    reset_launch_counts()
    got = sharded(imgs, projs, dvs)
    torch.cuda.synchronize()
    counts = launches_of("sweep_variance", "conv0_fused", "softmax_regression")
    rng_ = DEPTH_MAX - DEPTH_MIN
    d_diff = (got["depth"] - want["depth"]).abs()
    near_int = near_integer_index(want["depth"], d_diff)
    d_err = d_diff.max().item()
    c_err = (got["photometric_confidence"] - want["photometric_confidence"]).abs()[~near_int].max().item()
    times = {"sharded": [], "whole": []}
    for tag in ("sharded", "whole", "whole", "sharded"):
        fn = sharded if tag == "sharded" else whole
        for _ in range(2):
            t0 = time.perf_counter()
            fn(imgs, projs, dvs)
            torch.cuda.synchronize()
            times[tag].append(time.perf_counter() - t0)
    log("parallel", f"make_sharded_infer over [cuda:0, cuda:0], 2 headline requests (bf16, K4): depth max|err| "
                    f"{d_err:.3e} vs {SLICE_DEPTH_TOL * rng_:.3e}, conf max|err| {c_err:.3e} vs {SLICE_CONF_ATOL:.0e} "
                    f"({int(near_int.sum().item())} pixels excluded near an integer index) against the unsharded "
                    f"B=2 forward; launches {counts}; seconds for the pair: sharded "
                    f"{statistics.median(times['sharded']):.4f}, unsharded {statistics.median(times['whole']):.4f}")
    if not d_err <= SLICE_DEPTH_TOL * rng_ or not c_err <= SLICE_CONF_ATOL:
        raise AssertionError("the sharded forward disagrees with the unsharded one")
    if counts != dict.fromkeys(counts, 2):
        raise AssertionError(f"K1, K4 and K2 must launch once per sample of the sharded forward: {counts}")
    for k, c in counts.items():
        extra.setdefault(k, {})["launches_sharded_infer"] = c
    del model, whole_model, whole, sharded, got, want

    # the consistency filter over [cuda:0, cuda:0] on the eval phase's 16 maps
    kw = dict(NviewFilter=10, photomask=0.0, geomask=1, condmask_pixel=6.0, condmask_depth=0.5)
    serial = fuse_scan(*scan_maps, device=dev, **kw)
    split = fuse_scan(*scan_maps, devices=[dev, dev], **kw)
    masks_equal = all(np.array_equal(a[k], b[k]) for a, b in zip(serial, split)
                      for k in ("photo_mask", "geo_mask", "final_mask"))
    depth_off = max(float(np.max(np.abs(a["depth_est_averaged"] - b["depth_est_averaged"])
                                 / np.maximum(np.abs(a["depth_est_averaged"]), 1e-30))) for a, b in zip(serial, split))
    log("parallel", f"fuse_scan over [cuda:0, cuda:0], {len(serial)} reference views of the eval phase: masks "
                    f"{'equal' if masks_equal else 'DIFFER'}, depth_est_averaged max relative diff {depth_off:.2e} "
                    f"(limit {FUSE_RTOL:.0e}) against the serial filter")
    if not masks_equal or not depth_off <= FUSE_RTOL or len(split) != len(serial):
        raise AssertionError("the sharded filter disagrees with the serial one")
    shutil.rmtree(work, ignore_errors=True)
    return extra


def phase_api(gen, scan_maps: tuple) -> dict:
    """The JAX package's API ported last, on the card, with the launch counts
    set to 0 before and read after (the path runs no hand-written kernel but
    the BatchNorm kernels, phase 14's):
    geometric_filter_stack for every reference view of the eval phase's
    16-view scan (its count held equal to fuse_reference_view's), and
    Hourglass3d(8) in bf16 eval mode on CostRegNet's conv0 output at the
    headline (ms, peak), and in f32 on a crop against the same block on the
    CPU. Returns no kernel fields."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from scene_3dreconstruction_mvsnet_tpu_torch.eval import fuse_reference_view, geometric_filter_stack
    from scene_3dreconstruction_mvsnet_tpu_torch.models import Hourglass3d, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    kernels.reset_launch_counts()
    depths, confs, Ks, Es, pair_data, view_ids = scan_maps
    row = {v: i for i, v in enumerate(view_ids)}
    kw = dict(condmask_pixel=6.0, condmask_depth=0.5)  # the eval phase's loosened filter
    stack_ms, fused_ms, counted = [], [], 0
    for ref_view, src_views in pair_data:
        r, srcs = row[ref_view], [row[v] for v in src_views[:10]]
        args = [t.to(dev) for t in (torch.from_numpy(depths[r]), torch.from_numpy(Ks[r]), torch.from_numpy(Es[r]),
                                    torch.from_numpy(depths[srcs]), torch.from_numpy(Ks[srcs]),
                                    torch.from_numpy(Es[srcs]))]
        with torch.inference_mode():
            geometric_filter_stack(*args, **kw)  # warm
            stack_ms.append(cuda_time_ms(lambda: geometric_filter_stack(*args, **kw), 5))
            geo_sum, _, masks = geometric_filter_stack(*args, **kw)
        t0 = time.perf_counter()
        fused = fuse_reference_view(depths[r], confs[r], Ks[r], Es[r], depths[srcs], Ks[srcs], Es[srcs],
                                    photomask=0.0, geomask=1, device=dev, **kw)
        fused_ms.append(1e3 * (time.perf_counter() - t0))
        if not np.array_equal(geo_sum.cpu().numpy(), fused["geo_mask_sum"]) or masks.shape[0] != len(srcs):
            raise AssertionError(f"geometric_filter_stack's count differs from fuse_reference_view's for view "
                                 f"{ref_view}")
        counted += int(geo_sum.sum())
    log("api", f"geometric_filter_stack: {len(pair_data)} reference views of the eval phase's scan, geo_mask_sum "
               f"equal to fuse_reference_view's for every one ({counted} consistent (pixel, source) pairs); "
               f"ms a reference view: geometric_filter_stack {statistics.median(stack_ms):.3f} (median; CUDA events, "
               f"device tensors in), fuse_reference_view {statistics.median(fused_ms):.3f} (median; host clock, numpy "
               f"in and out, photo/geo/final masks and the fused depth too)")

    # Hourglass3d(8) on CostRegNet's conv0 output at the headline: bf16, eval
    block = random_init_(Hourglass3d(8), torch.Generator().manual_seed(SEED)).eval()
    cpu_block = Hourglass3d(8).eval()
    cpu_block.load_state_dict(block.state_dict())
    block.to(dev)
    x = torch.relu(torch.randn((1, 8, D, H // 4, W // 4), generator=gen, device=dev)).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        y = block(x)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        ms = cuda_time_ms(lambda: block(x), 5)
    if y.shape != x.shape or y.dtype != torch.bfloat16 or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"Hourglass3d gave {tuple(y.shape)} {y.dtype} (finite: {bool(torch.isfinite(y).all())})")
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        block(x)
        torch.cuda.synchronize()
    by_kernel: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:3]
    log("api", f"Hourglass3d(8), bf16 eval, [1, 8, {D}, {H // 4}, {W // 4}]: {ms:.3f} ms a forward (CUDA events, "
               f"mean of 5 after one), peak {peak:.3f} GiB above its input; device time of one forward "
               f"{sum(by_kernel.values()):.3f} ms (profiler), the largest kernels: "
               + "; ".join(f"{name[:60]} {t:.3f} ms" for name, t in top))
    del x, y

    # f32 on a crop: the card (TF32 off) against the CPU
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the f32 comparison")
    crop = torch.randn((1, 8, 32, 64, 64), generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        want = cpu_block(crop)
        got = block(crop.to(dev)).cpu()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    log("api", f"Hourglass3d(8) f32 on [1, 8, 32, 64, 64], the card against the CPU: max|err| {err:.3e}, limit "
               f"{API_HOURGLASS_TOL:.0e} x {scale:.3e}")
    if not err <= API_HOURGLASS_TOL * scale:
        raise AssertionError("Hourglass3d on the card disagrees with the CPU")
    launched = without_bn(kernels.launch_counts())
    if launched:
        raise AssertionError(f"the api phase launched hand-written kernels: {launched}")
    log("api", f"phase done in {time.perf_counter() - t_phase:.1f} s; no hand-written kernel launched but "
               f"Hourglass3d's BatchNorm ({kernels.launch_counts()['batch_norm_eval']} eval launches)")
    return {}


def _sweep_rank(rank: int, port: int, work: str, world: int) -> None:
    """One rank of the sweep phase, sharing cuda:0 with the others over gloo.
    With 2 ranks (data=1 x sweep=2): the headline request (96 planes a rank)
    in f32 and in bf16 with K4, SWEEP_REQUESTS times each after a warm-up;
    with 4 (data=2 x sweep=2): the recipe's step through
    make_sharded_train_step(mesh=) (SGD), once in f32, GLOO_STEPS times in
    bf16, once more in f32 and once in f32 with remat. The counts are set to 0 before each
    request or step and read after it; everything goes to
    ``work/sweep<world>_rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import reset_launch_counts
    from scene_3dreconstruction_mvsnet_tpu_torch.parallel import (
        initialize_multihost, make_mesh, make_sharded_train_step, volume_sharding,
    )
    from scene_3dreconstruction_mvsnet_tpu_torch.train import make_scheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo", local_rank=0, timeout_s=300)
    dev = torch.device("cuda", 0)
    task = torch.load(Path(work) / f"sweep{world}.pt", weights_only=False)
    mesh = make_mesh(data=world // 2, sweep=2)
    split = volume_sharding(mesh)
    out: dict = {"coords": (mesh.data_index, mesh.sweep_index)}
    if world == 2:
        for tag, dtype, fused in (("f32", None, False), ("bf16 fused conv0", torch.bfloat16, True)):
            model = MVSNet(dtype=dtype, fused_conv0=fused, volume_sharding=split)
            model.load_state_dict(task["state"])
            infer = make_infer_step(model, dev)
            planes = []
            model.cost_regularization.register_forward_pre_hook(lambda m, args: planes.append(args[0].shape[1]))
            infer(*task["request"])  # warm-up: cuDNN's picks, the gloo connections
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            planes.clear()
            rec = {"seconds": [], "launches": [], "planes": planes}
            for _ in range(SWEEP_REQUESTS):
                reset_launch_counts()
                t0 = time.perf_counter()
                res = infer(*task["request"])
                torch.cuda.synchronize()
                rec["seconds"].append(time.perf_counter() - t0)
                rec["launches"].append(launches_of("sweep_variance", "conv0_fused", "softmax_regression"))
            rec.update(depth=res["depth"].cpu(), conf=res["photometric_confidence"].cpu(),
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            out[tag] = rec
            del model, infer, res
            torch.cuda.empty_cache()
    else:
        for tag, dtype, steps, remat in (("f32", None, 1, False), ("bf16", torch.bfloat16, GLOO_STEPS, False),
                                         ("f32 again", None, 1, False), ("f32 remat", None, 1, True)):
            model = MVSNet(dtype=dtype, remat=remat, volume_sharding=split).to(dev)
            model.load_state_dict(task["state"])
            opt = torch.optim.SGD(model.parameters(), lr=T_LR)
            step, shard_fn = make_sharded_train_step(model, opt, make_scheduler(opt, T_LREPOCHS, 1000), dev,
                                                     mesh=mesh)
            rows = shard_fn(task["batch"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec = {"seconds": [], "launches": [], "rows": int(rows["imgs"].shape[0])}
            for i in range(steps):
                reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(step(rows)["loss"])  # waits for the step
                rec["seconds"].append(time.perf_counter() - t0)
                rec["launches"].append(launches_of("sweep_variance_emit", "paired_grad", "warp_grad"))
                if i == 0:
                    rec.update(loss=loss, grads={n: p.grad.float().cpu() for n, p in model.named_parameters()})
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            rec["state"] = {k: v.cpu() for k, v in model.state_dict().items()}  # parameters and BatchNorm buffers
            out[tag] = rec
            del model, opt, step
            torch.cuda.empty_cache()
    torch.save(out, Path(work) / f"sweep{world}_rank{rank}.pt")
    dist.destroy_process_group()


def phase_sweep(repo: Path, gen, initial: dict) -> dict:
    """The cost volume's depth planes split over a sweep group (the JAX
    package's 'sweep' mesh axis), on gloo ranks sharing the one card: (a) the
    headline request on 2 ranks (data=1 x sweep=2, 96 planes each) against
    the one-process forward with the same weights, f32 and bf16 with K4;
    (b) the recipe's step on 4 ranks (data=2 x sweep=2, the JAX package's
    tests/test_parallel.py mesh) against the one-process B=4 step, f32 once
    and bf16 GLOO_STEPS times; (c) on the same 4 ranks, the f32 step with
    remat against each rank's plain f32 step. Seconds over gloo with the
    ranks sharing one card are no speed figure. Returns the launch counts
    for the kernels' rows."""
    import shutil

    import numpy as np
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.train import make_scheduler, make_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    work = repo / "build" / "sweep_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    extra: dict = {}
    note = "(gloo ranks sharing one card: not a speed figure)"

    # (a) the headline request, one process, then 2 sweep ranks
    projs, dv = headline_rig(REF_CAMERAS[0])
    imgs = torch.randint(0, 256, (1, V, H, W, 3), generator=torch.Generator().manual_seed(SEED + 2), dtype=torch.uint8)
    request = (imgs, torch.from_numpy(projs)[None], torch.from_numpy(dv)[None])
    state = random_init_(MVSNet().to(dev), gen).state_dict()
    one = {}
    for tag, dtype, fused in (("f32", None, False), ("bf16 fused conv0", torch.bfloat16, True)):
        model = MVSNet(dtype=dtype, fused_conv0=fused)
        model.load_state_dict(state)
        infer = make_infer_step(model, dev)
        infer(*request)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = infer(*request)
        one[tag] = {"depth": res["depth"].cpu(), "conf": res["photometric_confidence"].cpu(),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del model, infer, res
    torch.cuda.empty_cache()
    torch.save({"state": {k: v.cpu() for k, v in state.items()}, "request": request}, work / "sweep2.pt")
    t0 = time.perf_counter()
    run_ranks(_sweep_rank, 2, work, 2)
    ranks = [torch.load(work / f"sweep2_rank{r}.pt", weights_only=False) for r in range(2)]
    spawn_s = time.perf_counter() - t0
    rng_ = DEPTH_MAX - DEPTH_MIN
    floor_d = (one["bf16 fused conv0"]["depth"] - one["f32"]["depth"]).abs().max().item()
    floor_c = (one["bf16 fused conv0"]["conf"] - one["f32"]["conf"]).abs().max().item()
    limits = {"f32": (SLICE_DEPTH_TOL * rng_, SLICE_CONF_ATOL), "bf16 fused conv0": (floor_d, floor_c)}
    want_launch = {"f32": {"sweep_variance": 1, "conv0_fused": 0, "softmax_regression": 1},
                   "bf16 fused conv0": {"sweep_variance": 1, "conv0_fused": 1, "softmax_regression": 1}}
    ok = True
    for tag, (d_lim, c_lim) in limits.items():
        w = one[tag]
        got = ranks[0][tag]
        d_diff = (got["depth"] - w["depth"]).abs()
        near_int = near_integer_index(w["depth"], d_diff)
        d_err = d_diff.max().item()
        c_err = (got["conf"] - w["conf"]).abs()[~near_int].max().item()
        same = all(torch.equal(r[tag]["depth"], got["depth"]) and torch.equal(r[tag]["conf"], got["conf"])
                   for r in ranks)
        log("sweep", f"headline request on 2 sweep ranks ({tag}) vs one process: depth max|err| {d_err:.3e} (limit "
                     f"{d_lim:.3e}{', the one-process bf16 forward from its f32 forward' if tag != 'f32' else ''}), "
                     f"conf max|err| {c_err:.3e} (limit {c_lim:.3e}; {int(near_int.sum().item())} pixels excluded "
                     f"near an integer index); the ranks' outputs {'equal' if same else 'DIFFER'}; the one "
                     f"process's peak device memory {w['peak_gib']:.2f} GiB")
        ok = ok and d_err <= d_lim and c_err <= c_lim and same
        for r, out in enumerate(ranks):
            rec = out[tag]
            log("sweep", f"  rank {r} (sweep index {out['coords'][1]}): K1 launches with D {rec['planes']} "
                         f"(of {D}); launches per request {rec['launches']}; seconds per request "
                         f"{', '.join(f'{x:.4f}' for x in rec['seconds'])} {note}; peak device memory "
                         f"{rec['peak_gib']:.2f} GiB")
            if any(c != want_launch[tag] for c in rec["launches"]) or rec["planes"] != [D // 2] * SWEEP_REQUESTS:
                raise AssertionError(f"rank {r} ({tag}) must launch {want_launch[tag]} a request on {D // 2} planes")
    if not ok:
        raise AssertionError("the split headline forward disagrees with the one-process forward or across ranks")
    extra["sweep_variance"] = {"launches_sweep_infer_per_rank_request": 1, "sweep_infer_planes_per_rank": D // 2}
    extra["conv0_fused"] = {"launches_sweep_infer_per_rank_request": 1}
    extra["softmax_regression"] = {"launches_sweep_infer_per_rank_request": 1}
    log("sweep", f"(a) {spawn_s:.1f} s with the 2 processes' start")

    # (b) the recipe's step: one process at B = 4, then data=2 x sweep=2
    batch = PlaneScene().batch()
    want = {}
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        ref = MVSNet(dtype=dtype).to(dev)
        ref.load_state_dict(initial)
        opt = torch.optim.SGD(ref.parameters(), lr=T_LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = float(make_train_step(ref, opt, make_scheduler(opt, T_LREPOCHS, 1000), dev)(batch)["loss"])
        want[tag] = {"loss": loss, "grads": {n: p.grad.float().cpu() for n, p in ref.named_parameters()},
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del ref, opt
    torch.cuda.empty_cache()
    torch.save({"state": initial, "batch": batch}, work / "sweep4.pt")
    t0 = time.perf_counter()
    run_ranks(_sweep_rank, 4, work, 4)
    ranks = [torch.load(work / f"sweep4_rank{r}.pt", weights_only=False) for r in range(4)]
    spawn_s = time.perf_counter() - t0

    floor_g, floor_at, _ = grad_err(want["bf16"]["grads"], want["f32"]["grads"])
    floor_loss = abs(want["bf16"]["loss"] - want["f32"]["loss"]) / abs(want["f32"]["loss"])
    limits = {"f32": (SWEEP_LOSS_RTOL, GLOO_F32_GRAD_TOL), "bf16": (max(GLOO_LOSS_RTOL["bf16"], floor_loss), floor_g)}
    ok = True
    for tag, (l_lim, g_lim) in limits.items():
        w = want[tag]
        for r, out in enumerate(ranks):
            got = out[tag]
            err, at, _ = grad_err(got["grads"], w["grads"])
            loss_off = abs(got["loss"] - w["loss"]) / abs(w["loss"])
            ok = ok and loss_off <= l_lim and err <= g_lim
            if r == 0:
                log("sweep", f"recipe step on data=2 x sweep=2 ({tag}, SGD) vs one process at B={TB}, step 1: loss "
                             f"{got['loss']:.6f} vs {w['loss']:.6f} (rtol {loss_off:.2e}, limit {l_lim:.2e}); "
                             f"gradients max|err| {err:.2e} x the largest |g| (at {at}; limit {g_lim:.2e}"
                             + (f", the one-process bf16 step's distance from its f32 step, at {floor_at})"
                                if tag == "bf16" else ")") + f"; the one process's peak device memory (its first "
                             f"step) {w['peak_gib']:.2f} GiB")
    per_step = {"sweep_variance_emit": TB // 2, "paired_grad": 1, "warp_grad": 1}
    same = all(torch.equal(v, out["bf16"]["state"][k]) for out in ranks[1:] for k, v in ranks[0]["bf16"]["state"].items())
    for r, out in enumerate(ranks):
        d_i, s_i = out["coords"]
        log("sweep", f"  rank {r} (data {d_i}, sweep {s_i}; {out['bf16']['rows']} rows, {TD // 2} planes): bf16 "
                     f"seconds per step {', '.join(f'{x:.4f}' for x in out['bf16']['seconds'])} {note}; launches per "
                     f"step {out['bf16']['launches']}; peak device memory bf16 {out['bf16']['peak_gib']:.2f} GiB, "
                     f"f32 {out['f32']['peak_gib']:.2f} GiB")
        if any(c != per_step for c in out["bf16"]["launches"] + out["f32"]["launches"]):
            raise AssertionError(f"rank {r}'s step must launch {per_step}")
    log("sweep", f"parameters and BatchNorm buffers after {GLOO_STEPS} bf16 steps {'equal' if same else 'DIFFER'} on "
                 f"all 4 ranks; (b) {spawn_s:.1f} s with the 4 processes' start")
    if not ok or not same:
        raise AssertionError("the data x sweep step disagrees with the one-process step or across its ranks")
    for k, n in per_step.items():
        extra.setdefault(k, {})["launches_sweep_train_per_rank_step"] = n

    # (c) remat with the split: each rank's f32 remat step (and its plain f32 step repeated) against its own
    # plain f32 step from the same weights
    remat_step = dict(per_step, sweep_variance_emit=2 * per_step["sweep_variance_emit"])  # K1-emit again in the bwd
    for r, out in enumerate(ranks):
        got, plain = out["f32 remat"], out["f32"]
        err, at, _ = grad_err(got["grads"], plain["grads"])
        repeat, _, _ = grad_err(out["f32 again"]["grads"], plain["grads"])
        bufs_equal = all(torch.equal(v, plain["state"][k]) for k, v in got["state"].items()
                         if "running" in k or "num_batches" in k)
        tracked = {int(v) for k, v in got["state"].items() if k.endswith("num_batches_tracked")}
        log("sweep", f"  rank {r}: f32 step with remat vs without: loss {got['loss']:.6f} vs {plain['loss']:.6f}; "
                     f"gradients max|err| {err:.2e} x the largest |g| (at {at}; limit {REMAT_GRAD_TOL:.0e}; the "
                     f"plain step repeated: {repeat:.2e}); "
                     f"BatchNorm buffers {'equal' if bufs_equal else 'DIFFER'}, num_batches_tracked {sorted(tracked)}; "
                     f"launches {got['launches'][0]}; peak device memory {got['peak_gib']:.2f} GiB (without "
                     f"{plain['peak_gib']:.2f}); seconds {got['seconds'][0]:.4f} (without {plain['seconds'][0]:.4f}) "
                     f"{note}")
        if got["launches"][0] != remat_step:
            raise AssertionError(f"rank {r}'s remat step must launch {remat_step}")
        if not (err <= REMAT_GRAD_TOL and bufs_equal and tracked == {1} and got["loss"] == plain["loss"]):
            raise AssertionError(f"rank {r}: the remat split step disagrees with the plain split step")
    extra["sweep_variance_emit"]["launches_sweep_remat_per_rank_step"] = remat_step["sweep_variance_emit"]
    shutil.rmtree(work, ignore_errors=True)
    log("sweep", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return extra


def kernel_shape_cases():
    """More inference shapes at which K1 and K2 are held to their plain
    versions: 3 views and 96 planes at 512x640, 5 views and 192 planes at
    864x1152 (both a translation rig, SyntheticRig's), 5 views of the BDS8
    49-camera ring and the 4-camera bin ring with 192 planes at 512x640
    (planes 425 to 905 mm), features at a quarter of the images, batch 1;
    and the bin tree's translation rig at batch 2 (4 views, 192 planes,
    512x640, references 0 and 1, the depth values its camera files give,
    SyntheticRig.write_cam_file's). Yields (name, [per sample: projections
    [V, 4, 4]], depth values [B, D], feature height, width)."""
    import numpy as np

    from scene_3dreconstruction_mvsnet_tpu_torch.data.synthetic import RingRig, SyntheticRig

    def projections(rig, views, K):
        projs = np.stack([rig.extrinsics(v) for v in views])
        projs[:, :3, :4] = K @ projs[:, :3, :4]
        return projs

    def planes(d):
        return np.linspace(DEPTH_MIN, DEPTH_MAX, d, dtype=np.float32)[None]

    for name, (h, w), views, d in (("dtu_small_3v_96d_512x640", (512, 640), 3, 96),
                                   ("dtu_full_5v_192d_864x1152", (864, 1152), 5, 192)):
        rig = SyntheticRig(n_views=views, img_hw=(h, w), baseline=2.0, focal=0.7 * w)
        yield name, [projections(rig, range(views), rig.K / 4.0)], planes(d), h // 4, w // 4
    yield "bds8_49cam_5v_192d_512x640", [headline_rig(0, (512, 640))[0]], planes(192), 128, 160
    rig = RingRig(n_views=4, img_hw=(512, 640), z0=650.0, radius=120.0, height=-650.0)
    yield "bin_4cam_4v_192d_512x640", [projections(rig, range(4), rig.K / 4.0)], planes(192), 128, 160
    rig = SyntheticRig(n_views=4, img_hw=(512, 640), baseline=2.0, z0=500.0, slope_x=0.15, focal=0.8 * 640)
    lo, hi = rig.depth_range()  # as SyntheticRig.write_cam_file
    margin = 0.15 * (hi - lo) + 1.0
    dv = ((lo - margin) + (hi - lo + 2 * margin) / 192 * np.arange(192)).astype(np.float32)
    K = rig.K.copy()
    K[:2] /= 4.0
    samples = [projections(rig, [ref] + srcs[:3], K) for ref, srcs in rig.pair_list()[:2]]
    yield "bin tree, batch 2", samples, np.stack([dv, dv]), 128, 160


def k1_k2_errors(gen, proj, dv, h: int, w: int, dtype, out_dtypes, channels: int = 32) -> tuple[float, float, dict]:
    """K1 and K2 against their plain versions on random inputs of one shape
    (these launches are not a main path's): projections ``proj`` [B, V, 4,
    4] and depth values ``dv`` [B, D], or per pixel [B, D, h, w], on the
    card. K1 once per sample on features [V, h, w, ``channels``] in
    ``dtype`` into each of ``out_dtypes``: its
    largest |error| against the plain f32 volume, and its largest error over
    its limit, the limit
    SWEEP_ATOL_F32 (f32 features) or SWEEP_ATOL_BF16 (bf16) x max|ref|,
    beyond a bf16 output's own rounding (2^-8 of the larger magnitude). K2 on
    logits [B, D, h, w] in ``dtype``: {"depth", "depth_tol" (REG_DEPTH_TOL x
    the depth range), "conf" (off the near-integer pixels; REG_CONF_ATOL),
    "excluded"}."""
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.softmax_regression import softmax_regression_cuda
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.sweep_variance import sweep_variance_cuda
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.plane_sweep import cost_volume_variance
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.regression import regress_depth_and_confidence

    dev = torch.device("cuda")
    (B, V), D = proj.shape[:2], dv.shape[1]
    k1_err = k1_over = 0.0
    with torch.inference_mode():
        for b in range(B):
            feats = torch.rand((V, h, w, channels), generator=gen, device=dev).to(dtype)
            ref = cost_volume_variance(feats[None], proj[b:b + 1], dv[b:b + 1], out_dtype=torch.float32)[0]
            atol = (SWEEP_ATOL_BF16 if dtype == torch.bfloat16 else SWEEP_ATOL_F32) * ref.abs().max().item()
            for out_dtype in out_dtypes:
                out = sweep_variance_cuda(feats, proj[b], dv[b], out_dtype=out_dtype).float()
                torch.cuda.synchronize()
                diff = (out - ref).abs()
                k1_err = max(k1_err, diff.max().item())
                if out_dtype == torch.bfloat16:
                    diff -= 2.0 ** -8 * torch.maximum(out.abs(), ref.abs())
                k1_over = max(k1_over, diff.max().item() / atol)
                del out, diff
            del ref
        logits = (torch.randn((B, D, h, w), generator=gen, device=dev) * 3.0).to(dtype)
        ref_depth, ref_conf = regress_depth_and_confidence(logits.float(), dv)
        depth, conf = softmax_regression_cuda(logits, dv)
        torch.cuda.synchronize()
        d_diff = (depth - ref_depth).abs()
        near_int = near_integer_index(ref_depth, d_diff, dv)
    return k1_over, k1_err, {"depth": d_diff.max().item(), "depth_tol": REG_DEPTH_TOL * (dv[:, -1] - dv[:, 0]).min().item(),
                     "conf": (conf - ref_conf).abs()[~near_int].max().item(), "excluded": int(near_int.sum().item())}


def check_kernel_shape_cases(gen) -> None:
    """K1 and K2 at each of ``kernel_shape_cases``' shapes against their
    plain versions on the same inputs (``k1_k2_errors``): K1 on bf16
    features into bf16 (the bf16 model's call) and into f32, K2 on bf16
    logits; raises if one is beyond its limit."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    failed = []
    for name, samples, dvs, h, w in kernel_shape_cases():
        proj, dv = torch.from_numpy(np.stack(samples)).to(dev), torch.from_numpy(dvs).to(dev)
        worst, _, k2 = k1_k2_errors(gen, proj, dv, h, w, torch.bfloat16, (torch.bfloat16, torch.float32))
        shape = f"{len(samples)}x[{samples[0].shape[0]}v, {dv.shape[1]}d, {h}x{w}x32]"
        log("recipes", f"{name}: K1 at {shape} bf16 features, bf16 and f32 out: max|err| {worst:.3f} x its "
                       f"tolerance; K2 on [{len(samples)}, {dv.shape[1]}, {h}, {w}] bf16 logits: depth max|err| "
                       f"{k2['depth']:.3e} vs {k2['depth_tol']:.3e}, conf max|err| {k2['conf']:.3e} vs "
                       f"{REG_CONF_ATOL:.0e} ({k2['excluded']} pixels excluded near an integer index)")
        if not (worst <= 1.0 and k2["depth"] <= k2["depth_tol"] and k2["conf"] <= REG_CONF_ATOL):
            failed.append(name)
    if failed:
        raise AssertionError(f"K1 or K2 disagrees with its plain version at the shapes of {failed}")


def recipe_kernel_shapes() -> dict[str, tuple]:
    """The inference kernels' shapes on each preset's path, from the presets
    (recipes.PRESETS) and eval_cli's registries: case -> (B, V, D, feature
    height, width, dtype). The train_BlenderDS step's emit, terms and
    warp-backward kernels take the "train_BlenderDS step" shapes."""
    from scene_3dreconstruction_mvsnet_tpu_torch.eval_cli import DICT_IMG_RES
    from scene_3dreconstruction_mvsnet_tpu_torch.recipes import PRESETS

    train = PRESETS["train_BlenderDS"]["args"]
    hw = (RECIPE_HW[0] // 4, RECIPE_HW[1] // 4)
    cases = {"train_BlenderDS step": (train["batch_size"], train["NtrainViews"], train["numdepth"], *hw, train["dtype"]),
             "train_BlenderDS test pass": (train["batch_size"], train["NtestViews"], train["numdepth"], *hw,
                                           train["dtype"])}
    for preset in RECIPE_EVAL_TREES:
        args = PRESETS[preset]["args"]
        # images of the registry's aspect rescale to its size exactly, and
        # read_rescale_crop_img then crops each side to a multiple of 32
        # (DTU: 1200x1600 -> 600x800 -> 576x800)
        h, w = (side // 32 * 32 for side in DICT_IMG_RES[args["dataset_name"]])
        cases[preset] = (1, args["NviewGen"], args["numdepth"], h // 4, w // 4, args.get("dtype", "float32"))
    cases["eval_DTU --dtype bfloat16"] = cases["eval_DTU"][:5] + ("bfloat16",)
    return cases


def infer_kernel_rows(gen, case: str, projs, dv, dtype: str) -> list[dict]:
    """K1 and K2 at one inference shape of a preset against their plain
    versions on the card (``k1_k2_errors``): ``projs`` [B, V, 4, 4] and
    ``dv`` [B, D], a batch of the preset's samples, random features and
    logits in ``dtype`` ("float32" or "bfloat16"), K1's output in it too;
    each timed beside its plain version (K1 on sample 0), with its bound.
    The rows of the kernels' line, their launches still to be filled in."""
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.softmax_regression import softmax_regression_cuda
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.sweep_variance import sweep_variance_cuda
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.plane_sweep import cost_volume_variance
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.regression import regress_depth_and_confidence

    dev = torch.device("cuda")
    B, V, D, h, w, _ = recipe_kernel_shapes()[case]
    proj, dv = projs.to(dev), dv.to(dev)
    if tuple(proj.shape[:2]) != (B, V) or tuple(dv.shape) != (B, D):
        raise AssertionError(f"{case}: the preset's samples give {tuple(proj.shape)} and {tuple(dv.shape)}, "
                             f"not B={B}, V={V}, D={D}")
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tag = "bf16" if dt == torch.bfloat16 else "f32"
    k1_over, k1_err, k2 = k1_k2_errors(gen, proj, dv, h, w, dt, (dt,))
    with torch.inference_mode():
        feats = torch.rand((1, V, h, w, 32), generator=gen, device=dev).to(dt)
        k1 = timed_pair(lambda: sweep_variance_cuda(feats[0], proj[0], dv[0]),
                        lambda: cost_volume_variance(feats, proj[:1], dv[:1]),
                        iters=10, plain_iters=3, kernel="sweep_variance_kernel")
        k1_bound = bound((feats.numel() + D * h * w * 32) * feats.element_size(),
                         sweep_flops(proj[0], dv[0], h, w, 32), "f32")
        del feats
        logits = (torch.randn((B, D, h, w), generator=gen, device=dev) * 3.0).to(dt)
        k2_t = timed_pair(lambda: softmax_regression_cuda(logits, dv),
                          lambda: regress_depth_and_confidence(logits.float(), dv),
                          iters=20, plain_iters=5, kernel="softmax_regression_kernel")
        k2_bound = bound(logits.numel() * logits.element_size() + 2 * B * h * w * 4, 5 * logits.numel(), "f32")
    log("recipes", f"{case}: K1 [{V},{h},{w},32] {tag} -> [{D},{h},{w},32] {tag}, {B} sample(s): max|err| "
                   f"{k1_err:.3e} ({k1_over:.3f} x its limit); kernel {k1[0]:.4f} ms (device {fmt_ms(k1[3])}), plain {k1[1]:.4f} ms, "
                   f"bound {k1_bound['bound_ms']:.4f} ms ({k1_bound['bound_by']}). K2 on [{B},{D},{h},{w}] {tag} logits: "
                   f"depth max|err| {k2['depth']:.3e} vs {k2['depth_tol']:.3e}, conf max|err| {k2['conf']:.3e} vs "
                   f"{REG_CONF_ATOL:.0e} ({k2['excluded']} pixels excluded near an integer index); kernel "
                   f"{k2_t[0]:.4f} ms (device {fmt_ms(k2_t[3])}), plain {k2_t[1]:.4f} ms, bound "
                   f"{k2_bound['bound_ms']:.4f} ms ({k2_bound['bound_by']})")
    if not (k1_over <= 1.0 and k2["depth"] <= k2["depth_tol"] and k2["conf"] <= REG_CONF_ATOL):
        raise AssertionError(f"{case}: K1 or K2 disagrees with its plain version")
    common = {"route": "cuda", "case": case, "library_ms": None}
    return [
        {"name": "sweep_variance", **common,
         "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/sweep_variance.cu",
         "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/sweep_variance.py:607",
         "shape": f"[{V},{h},{w},32] {tag} -> [{D},{h},{w},32] {tag}", "max_abs_err": k1_err,
         "max_abs_err_over_tol": k1_over,
         "ms": k1[0], "device_ms": k1[3], "plain_ms": k1[1], **k1_bound, "library_none": NO_LIBRARY["sweep_variance"]},
        {"name": "softmax_regression", **common,
         "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/softmax_regression.cu",
         "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/softmax_regression.py:86",
         "shape": f"[{B},{D},{h},{w}] {tag} logits -> 2x[{B},{h},{w}] f32", "max_abs_err": k2["depth"],
         "tol": k2["depth_tol"], "conf_max_abs_err": k2["conf"], "conf_tol": REG_CONF_ATOL, "ms": k2_t[0],
         "device_ms": k2_t[3], "plain_ms": k2_t[1], **k2_bound, "library_none": NO_LIBRARY["softmax_regression"]},
    ]


def run_recipe(repo: Path, preset: str, argv: list[str], env: dict, log_path: Path) -> tuple[float, dict, str]:
    """``python -m scene_3dreconstruction_mvsnet_tpu_torch.recipes <preset>
    <argv>`` in a process of its own, from the checkout's root, with ``env``
    added to the environment and TF32 off (NVIDIA_TF32_OVERRIDE=0: cuDNN's
    convs in the child compute in f32, as this script's own do, so its f32
    maps can be held to the plain path here); its output goes to
    ``log_path``, its tail is printed if it fails. Returns (wall seconds,
    the process's kernel launches as it logged them at its exit, its
    output)."""
    import os

    from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels

    launch_log = log_path.with_suffix(".launches.jsonl")
    launch_log.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "scene_3dreconstruction_mvsnet_tpu_torch.recipes", preset, *argv]
    t0 = time.perf_counter()
    env = {**os.environ, **env, "NVIDIA_TF32_OVERRIDE": "0", kernels.LAUNCH_LOG_ENV: str(launch_log)}
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=RECIPE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    log_path.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        print((proc.stdout + proc.stderr)[-4000:], flush=True)
        raise AssertionError(f"recipes {preset} exited with {proc.returncode}")
    return wall, kernels.read_launch_log(launch_log), proc.stdout


def _grab(pattern: str, text: str) -> float:
    found = re.search(pattern, text)
    if found is None:
        raise AssertionError(f"no match for {pattern!r} in a runner's output")
    return float(found.group(1))


def phase_recipes(repo: Path, gen) -> list[dict]:
    """Every preset of configs/workloads.json through the port's runner, each
    in a process of its own, on synthetic trees under build/recipes_smoke/
    at the preset's own settings; first, in this process, K1 and K2 at
    ``kernel_shape_cases``' shapes and the kernels held to their plain
    versions at each new shape the presets give them, and the
    train_BlenderDS step's feature gradient held to plain autograd, its
    seconds, stage split and peak memory. Each runner process's launches
    (logged at its exit) must be its path's. Returns the kernels' rows at
    the presets' shapes, their launches filled in."""
    import os
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.data import Loader, find_dataset_def, pack_u8_imgs
    from scene_3dreconstruction_mvsnet_tpu_torch.data.synthetic import (
        SyntheticRig, make_blender_tree, make_dtu_tree, write_scan_list,
    )
    from scene_3dreconstruction_mvsnet_tpu_torch.eval_cli import DICT_CAM_SUBFOLDER, DICT_IMG_RES, DICT_IMG_SUBFOLDER
    from scene_3dreconstruction_mvsnet_tpu_torch.io import read_pfm, read_ply
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import (
        cost_volume_variance, regress_depth_and_confidence,
    )
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.paired_sweep import paired_cost_volume
    from scene_3dreconstruction_mvsnet_tpu_torch.recipes import PRESETS
    from scene_3dreconstruction_mvsnet_tpu_torch.train import (
        load_model, make_optimizer, make_scheduler, make_train_step,
    )
    from scene_3dreconstruction_mvsnet_tpu_torch.train.state import batch_to_device

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    units = {}  # case -> (the unit its launches are counted in, how many of them the runner's path took)
    work = repo / "build" / "recipes_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # the trees: the blender and DTU train layouts of the recipe's plane
    # scene (PlaneScene's cameras), and the three registries' eval layouts of
    # the inward ring
    t0 = time.perf_counter()
    rig = dict(img_hw=RECIPE_HW, z0=PlaneScene.Z0, slope_x=PlaneScene.SLOPE, baseline=PlaneScene.BASELINE,
               focal=PlaneScene.FOCAL)
    train = {"train_BlenderDS": work / "bds8_train", "train_DTU": work / "dtu_train"}
    with ThreadPoolExecutor(2 + len(RECIPE_EVAL_TREES)) as pool:  # the renders and PNG encodes side by side
        writes = [pool.submit(make_blender_tree, str(train["train_BlenderDS"]), scan="scene_000", n_lights=7,
                              rig=SyntheticRig(n_views=RECIPE_TRAIN_VIEWS["train_BlenderDS"], **rig), ndepths=TD),
                  pool.submit(make_dtu_tree, str(train["train_DTU"]), scan="scan1",
                              rig=SyntheticRig(n_views=RECIPE_TRAIN_VIEWS["train_DTU"], **rig), ndepths=TD)]
        evals = {preset: pool.submit(RingScene(n_cams, h, w).write_registry_tree, str(work / name), name, scan,
                                     PRESETS[preset]["args"]["numdepth"], views,
                                     PRESETS[preset]["args"].get("pairfile", "pair.txt"))
                 for preset, (name, n_cams, (h, w), views, scan) in RECIPE_EVAL_TREES.items()}
        for future in writes:
            future.result()
        testpaths = {preset: Path(future.result()) for preset, future in evals.items()}
    # DTU's own depth line (425 mm, 2.5 mm; the recipe's sweep): dtu_yao's f32
    # arange, the reference's, ends at exactly D intervals and gives D + 1
    # planes for the depth lines make_dtu_tree writes for this rig
    for cam in (train["train_DTU"] / "Cameras" / "train").iterdir():
        lines = cam.read_text().splitlines()
        cam.write_text("\n".join(lines[:-1] + [f"{T_DEPTH_MIN:.6f} {T_INTERVAL / 1.06:.6f}"]) + "\n")
    for preset, root in train.items():
        write_scan_list(str(root / "list.txt"), ["scene_000" if preset == "train_BlenderDS" else "scan1"])
    for preset, (name, _, _, _, scan) in RECIPE_EVAL_TREES.items():
        write_scan_list(str(work / name / "test.txt"), [scan])
    ckpt = work / "model.ckpt"
    model = random_init_(MVSNet(), torch.Generator().manual_seed(SEED))
    torch.save({"model": {"module." + k: v for k, v in model.state_dict().items()}}, ckpt)
    log("recipes", f"trees made in {time.perf_counter() - t0:.1f} s. Cuts: one scan a tree; --epochs 1 (and --seed "
                   f"1); train_BlenderDS {RECIPE_TRAIN_VIEWS['train_BlenderDS']} views x 7 lights at {RECIPE_HW}, "
                   f"train_DTU {RECIPE_TRAIN_VIEWS['train_DTU']} views x 7 lights (its cam files' depth line DTU's "
                   "425 mm + 2.5 mm), their scene lists the trees' own (--trainlist, --testlist); eval_BlenderDS views 30, 34, 46, 47 of a 49-camera ring and "
                   "eval_binpicking a 4-camera ring at 512x640, their scene lists the presets' own (scene_000, "
                   "binpicking); eval_DTU 11 ring views at 1200x1600, its scene list the tree's own (--testlist); "
                   f"random weights (seed {SEED}) for the eval presets, train_cli's own initialisation for the "
                   "train presets; synthetic trees, no real scans")

    # the train_BlenderDS batch, as its loader gives it, and the test pass's
    def dataset(preset, mode):
        args = PRESETS[preset]["args"]
        root = train[preset]
        return find_dataset_def(args["dataset"])(
            str(root), str(root / "list.txt"), mode, args["NtrainViews" if mode == "train" else "NtestViews"],
            args["numdepth"], args["interval_scale"], Nlights=args.get("Nlights", "1:1"), seed=1)

    for preset in train:  # the planes each train tree's loader gives
        planes = len(dataset(preset, "train")[0]["depth_values"])
        if planes != PRESETS[preset]["args"]["numdepth"]:
            raise AssertionError(f"{preset}'s tree gives {planes} depth planes")
    bds8 = PRESETS["train_BlenderDS"]["args"]
    batch = pack_u8_imgs(next(iter(Loader(dataset("train_BlenderDS", "train"), batch_size=bds8["batch_size"]))))
    test_batch = next(iter(Loader(dataset("train_BlenderDS", "test"), batch_size=bds8["batch_size"])))
    check_kernel_shape_cases(gen)  # K1 and K2 at more inference shapes, then at the presets' own
    rows = train_kernel_rows(gen, torch.from_numpy(batch["proj_matrices"]), torch.from_numpy(batch["depth_values"][0]),
                             RECIPE_HW[0] // 4, RECIPE_HW[1] // 4, "train_BlenderDS step")
    want_train = recipe_kernel_shapes()["train_BlenderDS step"]
    if batch["imgs"].shape[:2] != want_train[:2] or batch["depth_values"].shape[1] != want_train[2]:
        raise AssertionError(f"the train_BlenderDS batch is {batch['imgs'].shape}, not the preset's {want_train}")
    rows += infer_kernel_rows(gen, "train_BlenderDS test pass", torch.from_numpy(test_batch["proj_matrices"]),
                              torch.from_numpy(test_batch["depth_values"]), bds8["dtype"])

    # the eval presets' first sample of each tree, as stage A reads it
    def eval_dataset(preset):
        args = PRESETS[preset]["args"]
        name = args["dataset_name"]
        return find_dataset_def("dataloader_eval")(
            str(testpaths[preset]), str(work / name / "test.txt"), "test", args["NviewGen"], args["numdepth"],
            args["interval_scale"], pairfile=args.get("pairfile", "pair.txt"), cam_subfolder=DICT_CAM_SUBFOLDER[name],
            img_subfolder=DICT_IMG_SUBFOLDER[name], img_res=DICT_IMG_RES[name], dataset_name=name, emit_u8=True)

    samples = {preset: eval_dataset(preset)[0] for preset in RECIPE_EVAL_TREES}
    for case, preset, dtype in (("eval_BlenderDS", "eval_BlenderDS", "float32"),
                                ("eval_binpicking", "eval_binpicking", "float32"),
                                ("eval_DTU", "eval_DTU", "float32"), ("eval_DTU --dtype bfloat16", "eval_DTU", "bfloat16")):
        sample = samples[preset]
        _, _, _, h, w, _ = recipe_kernel_shapes()[case]
        if sample["imgs"].shape[1:3] != (4 * h, 4 * w):
            raise AssertionError(f"{case}: stage A reads {sample['imgs'].shape} images, not {4 * h}x{4 * w}")
        rows += infer_kernel_rows(gen, case, torch.from_numpy(sample["proj_matrices"])[None],
                                  torch.from_numpy(sample["depth_values"])[None], dtype)

    # the train_BlenderDS step in this process: the feature gradient against
    # plain autograd, then its seconds, stage split and peak memory
    model16 = random_init_(MVSNet(dtype=torch.bfloat16).to(dev), gen)
    model32 = MVSNet().to(dev)
    model32.load_state_dict(model16.state_dict())
    on_dev = batch_to_device(batch, dev)
    for tag, m in (("f32", model32), ("bf16", model16)):
        got = feature_grad(m, on_dev, lambda f, p, d, dt: paired_cost_volume(f, p, d, out_dtype=dt)).float()
        want = feature_grad(m, on_dev, lambda f, p, d, dt: cost_volume_variance(f, p, d, out_dtype=dt)).float()
        scale, err = want.abs().max().item(), (got - want).abs().max().item()
        log("recipes", f"train_BlenderDS {tag} feature gradient (B={bds8['batch_size']}, V={bds8['NtrainViews']}), "
                       f"paired (K1-emit, K3-terms + K3) vs plain autograd: max|err| {err:.3e} vs "
                       f"{PAIRED_TOL[tag] * scale:.3e} (max|plain| {scale:.4e})")
        if not err <= PAIRED_TOL[tag] * scale:
            raise AssertionError(f"train_BlenderDS {tag}: the paired sweep's feature gradient disagrees with autograd")
        del got, want
    del on_dev
    step_s, peaks = {}, {}
    for tag, m, n in (("bf16", model16, 1 + RECIPE_STEPS), ("f32", model32, 2)):
        opt = make_optimizer(m, bds8["lr"])
        step = make_train_step(m, opt, make_scheduler(opt, bds8["lrepochs"], 1000), dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        secs, losses = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            losses.append(float(step(batch)["loss"]))  # waits for the step
            secs.append(time.perf_counter() - t0)
        counts = kernels.launch_counts()
        peaks[tag] = torch.cuda.max_memory_allocated() / 2**30
        step_s[tag] = statistics.median(secs[1:])
        want = {"sweep_variance_emit": n * bds8["batch_size"], "paired_grad": n, "warp_grad": n, "prob_conv": n,
                "prob_conv_backward": 3 * n}
        log("recipes", f"train_BlenderDS {tag} step in this process: seconds {', '.join(f'{x:.4f}' for x in secs)} "
                       f"(median after the first {step_s[tag]:.4f}); losses {', '.join(f'{x:.4f}' for x in losses)}; "
                       f"peak device memory {peaks[tag]:.2f} GiB; kernel launches "
                       f"{ {k: c for k, c in counts.items() if c} }")
        if without_bn(counts) != want or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train_BlenderDS {tag} steps: launches {counts} (want {want}) or losses {losses}")
        if tag == "bf16":
            timer = StageTimer(m, opt)
            timer.mark("start")
            step(batch)
            timer.mark("end")
            split = timer.split()
            total = sum(split.values())
            log("recipes", "train_BlenderDS bf16 step stage split (CUDA events): " + ", ".join(
                f"{k} {v:.3f} ms ({100 * v / total:.1f} %)" for k, v in split.items()) + f"; total {total:.3f} ms")
        del opt, step
    del model16, model32
    torch.cuda.empty_cache()

    # each preset through the runner, in its own process
    runs = {}
    for preset in ("train_BlenderDS", "train_DTU"):
        args, root = PRESETS[preset]["args"], train[preset]
        logdir = work / f"{preset}_log"
        var = "BDS8_TRAINING" if preset == "train_BlenderDS" else "DTU_TRAINING"
        wall, counts, out = run_recipe(
            repo, preset, ["--trainlist", str(root / "list.txt"), "--testlist", str(root / "list.txt"), "--epochs",
                           "1", "--seed", "1"], {var: str(root), "LOGDIR": str(logdir)}, work / f"{preset}.log")
        steps = len(dataset(preset, "train")) // args["batch_size"]
        n_test = len(dataset(preset, "test"))
        want = {"sweep_variance_emit": steps * args["batch_size"], "paired_grad": steps, "warp_grad": steps,
                "sweep_variance": n_test, "softmax_regression": -(-n_test // args["batch_size"])}
        want.update(prob_conv=steps + want["softmax_regression"], prob_conv_backward=3 * steps)
        launched = without_bn(counts)
        first_loss = _grab(r"Iter 0/\d+, LR:[^,]*, loss=([-\d.naif]+)", out)
        test_loss = _grab(r"avg_test_scalars: \{'loss': ([-\d.naife+]+)", out)
        train_wall = _grab(r"epoch 0 train wall: ([\d.]+)s", out)
        logged = (logdir / "train.log").read_text()
        ckpt_path = logdir / "model_000000.ckpt"
        load_model(str(ckpt_path), MVSNet())  # strict
        runs[preset] = counts
        if preset == "train_BlenderDS":
            units["train_BlenderDS step"] = ("train step", steps)
            units["train_BlenderDS test pass"] = ("test batch", want["softmax_regression"])
        log("recipes", f"{preset} through the runner: {wall:.1f} s; {steps} steps (B={args['batch_size']}, "
                       f"V={args['NtrainViews']}, D={args['numdepth']}, {args['dtype']}) in {train_wall:.2f} s "
                       f"({train_wall / steps:.4f} s a step, the first included), the test pass {n_test} samples "
                       f"at V={args['NtestViews']}; first loss {first_loss:.4f}, test loss {test_loss:.4f}; "
                       f"kernel launches {launched}; {ckpt_path.name} read back strict; its train.log "
                       f"{len(logged)} bytes")
        if launched != want:
            raise AssertionError(f"{preset}: launches {launched}, not its path's {want}")
        if not (math.isfinite(first_loss) and math.isfinite(test_loss)) or "avg_test_scalars" not in logged:
            raise AssertionError(f"{preset}: a loss is not finite or the log lacks the run")

    n_views = {preset: len(eval_dataset(preset)) for preset in RECIPE_EVAL_TREES}
    for case, preset, extra in (("eval_BlenderDS", "eval_BlenderDS", []), ("eval_binpicking", "eval_binpicking", []),
                                ("eval_DTU", "eval_DTU", []),
                                ("eval_DTU --dtype bfloat16", "eval_DTU", ["--dtype", "bfloat16"])):
        args = PRESETS[preset]["args"]
        name, _, _, _, scan = RECIPE_EVAL_TREES[preset]
        testpath, outdir = testpaths[preset], work / f"out_{case.replace(' ', '_').replace('-', '')}"
        if preset == "eval_DTU":  # eval_DTU.sh's environment
            argv, env = ["--testlist", str(work / name / "test.txt")] + extra, {
                "DTU_TESTING": str(testpath), "CKPT": str(ckpt), "OUTDIR": str(outdir)}
        else:
            argv, env = ["--testpath", str(testpath), "--loadckpt", str(ckpt), "--outdir", str(outdir)], {}
        wall, counts, out = run_recipe(repo, preset, argv, env, work / f"{case.replace(' ', '_')}.log")
        n = n_views[preset]
        launched = without_bn(counts)
        acq = outdir / testpath.name
        views = sorted(int(f[:-4]) for f in os.listdir(acq / scan / "depth_est") if f.endswith(".pfm"))
        files = [acq / scan / f"{kind}/{v:0>8}.pfm" for kind in ("depth_est", "confidence") for v in views]
        files += [acq / scan / f"mask/{v:0>8}_{k}.png" for v in views for k in ("photo", "geo", "final")]
        scan_id = int((re.findall(r"\d+", scan) or ["0"])[0])
        files.append(acq / f"mvsnet{scan_id:0>3}_l3.ply")
        missing = [str(f) for f in files if not f.exists()]
        if len(views) != n or missing:
            raise AssertionError(f"{case}: {len(views)} depth maps of {n} views; missing {missing[:10]}")
        points = int(read_ply(str(files[-1]))[0].shape[0])

        # one view against the plain path on the card, from the same sample
        sample = samples[preset]
        dt = torch.bfloat16 if "bfloat16" in extra else None
        m = MVSNet(dtype=dt)
        load_model(str(ckpt), m)
        m = m.to(dev).eval()
        ref_view = int(sample["filename"].split("/")[-1].replace("{}", ""))  # "<scan>/{}/<view>{}"
        with torch.inference_mode():
            imgs = torch.from_numpy(sample["imgs"]).to(dev).float() / 255.0
            proj = torch.from_numpy(sample["proj_matrices"]).to(dev)[None]
            dv = torch.from_numpy(sample["depth_values"]).to(dev)[None]
            V_, H_, W_ = imgs.shape[:3]
            feats = m.feature(imgs.to(dt if dt is not None else torch.float32)).reshape(1, V_, H_ // 4, W_ // 4, 32)
            cost = m.cost_regularization(cost_volume_variance(feats, proj, dv, out_dtype=dt))[..., 0].float()
            ref_depth, ref_conf = (t[0] for t in regress_depth_and_confidence(cost, dv))
        depth = torch.from_numpy(read_pfm(str(acq / scan / "depth_est" / f"{ref_view:0>8}.pfm"))[0].copy()).to(dev)
        conf = torch.from_numpy(read_pfm(str(acq / scan / "confidence" / f"{ref_view:0>8}.pfm"))[0].copy()).to(dev)
        rng_ = (dv[0, -1] - dv[0, 0]).item()
        d_diff = (depth - ref_depth).abs()
        near_int = near_integer_index(ref_depth[None], d_diff[None], dv)[0]
        d_err, c_err = d_diff.max().item(), (conf - ref_conf).abs()[~near_int].max().item()
        d_tol = SLICE_DEPTH_TOL * rng_  # bf16 too: the plain path runs the same bf16 convs
        stage_a, steady = _grab(r"stage A wall: ([\d.]+)s", out), _grab(r"steady_gen_time: ([\d.]+)", out)
        stage_b = _grab(r"stage B wall: ([\d.]+)s", out)
        runs[case] = counts
        units[case] = ("view", n)
        log("recipes", f"{case} through the runner: {wall:.1f} s; {n} views at {H_}x{W_} (V="
                       f"{args['NviewGen']}, D={args['numdepth']}, {'f32' if dt is None else 'bf16'}), filter: photomask "
                       f"{args['photomask']}, geomask {args['geomask']}, condmask {args['condmask_pixel']} px / "
                       f"{args['condmask_depth']}; kernel launches {launched}; stage A {stage_a:.3f} s "
                       f"(steady {steady:.4f} s a view), stage B {stage_b:.3f} s; {points} PLY points; view "
                       f"{ref_view} vs the plain path on the card: depth max|err| {d_err:.3e} vs {d_tol:.3e}, conf "
                       f"max|err| {c_err:.3e} vs {SLICE_CONF_ATOL:.0e} ({int(near_int.sum().item())} pixels excluded "
                       "near an integer index)")
        if launched != {"sweep_variance": n, "softmax_regression": n, "prob_conv": n}:
            raise AssertionError(f"{case}: K1, K2 and the prob conv must launch once per view ({n}) and nothing "
                                 f"else: {launched}")
        if not d_err <= d_tol or not c_err <= SLICE_CONF_ATOL:
            raise AssertionError(f"{case}: the depth map disagrees with the plain path")
        del m, feats, cost

    # the launches into the rows: the main path's, from the runner processes
    for row in rows:
        unit, n = units[row["case"]]
        row["launches"] = runs["train_BlenderDS" if row["case"].startswith("train") else row["case"]][row["name"]]
        row["launches_per"] = f"{row['launches'] / n:g} per {unit}"
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} ({row['case']}) was not launched on its preset's path")
    shutil.rmtree(work, ignore_errors=True)
    log("recipes", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return rows


def cascade_stage_inputs(gen, stage: int):
    """CasMVSNet's stage ``stage`` (2 or 3) on ring camera REF_CAMERAS[0]:
    its projections [1, V, 4, 4] at its resolution and its per-pixel planes
    [1, D, h, w] f32, built by the model's own ``pixel_planes`` from a
    smooth depth map at the previous stage's resolution that spans the
    middle of the sweep (the previous stage's depth stands in for it), the
    interval (DEPTH_MAX - DEPTH_MIN) / D as CasMVSNet divides by D0; on
    ``gen``'s device."""
    import torch
    import torch.nn.functional as F

    from scene_3dreconstruction_mvsnet_tpu_torch.models.cas_mvsnet import pixel_planes, stage_projection

    dev = gen.device
    projs, _ = headline_rig(REF_CAMERAS[0])
    s = stage - 1
    h, w = H // 4 * 2 ** s, W // 4 * 2 ** s
    coarse = torch.rand((1, 1, 9, 12), generator=gen, device=dev)
    prev = F.interpolate(coarse, size=(h // 2, w // 2), mode="bilinear", align_corners=False)[:, 0]
    prev = DEPTH_MIN + (DEPTH_MAX - DEPTH_MIN) * (0.25 + 0.5 * prev)
    interval = torch.full((1,), (DEPTH_MAX - DEPTH_MIN) / D, device=dev)
    planes = pixel_planes(prev, interval, CAS_NDEPTHS[s], CAS_RATIOS[s], (H, W), (h, w)).contiguous()
    return stage_projection(torch.from_numpy(projs).to(dev)[None], 2 ** s), planes


def phase_cascade(gen) -> list[dict]:
    """K1's and K2's per-pixel builds at CasMVSNet's stages 2 and 3
    (``cascade_stage_inputs``) against their plain versions
    (``k1_k2_errors``: K1 on bf16 features into bf16 and f32, K2 on bf16
    logits, the per-plane rows' tolerances), each timed beside its plain
    version with its bound; then a bf16 CasMVSNet (random weights from
    ``gen``) on a request of the ring: one forward on the request's device
    tensors under the sync debug mode "error" (the entry's own copies of
    the host arrays are left out: a blocking copy is a host wait by
    design), the launch counts reset just before it, and CAS_FORWARDS
    requests through ``make_infer_step`` timed. Returns the two kernels'
    rows per stage, their launches filled in from the checked forward."""
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
    from scene_3dreconstruction_mvsnet_tpu_torch.models import find_model_def, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.softmax_regression import softmax_regression_cuda
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.sweep_variance import sweep_variance_cuda
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.plane_sweep import cost_volume_variance
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.regression import regress_depth_and_confidence

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rows, failed = [], []
    for stage in (2, 3):
        proj, planes = cascade_stage_inputs(gen, stage)
        Dn, h, w = planes.shape[1:]
        C = CAS_CHANNELS[stage - 1]
        k1_over, k1_err, k2 = k1_k2_errors(gen, proj, planes, h, w, bf16, (bf16, torch.float32), channels=C)
        with torch.inference_mode():
            feats = torch.rand((1, V, h, w, C), generator=gen, device=dev).to(bf16)
            k1 = timed_pair(lambda: sweep_variance_cuda(feats[0], proj[0], planes[0]),
                            lambda: cost_volume_variance(feats, proj, planes),
                            iters=20, plain_iters=3, kernel="sweep_variance_kernel")
            # features and the per-pixel planes read once, the volume written once
            k1_bound = bound(feats.numel() * 2 + planes.numel() * 4 + Dn * h * w * C * 2,
                             sweep_flops(proj[0], planes[0], h, w, C), "f32")
            del feats
            logits = (torch.randn((1, Dn, h, w), generator=gen, device=dev) * 3.0).to(bf16)
            k2_t = timed_pair(lambda: softmax_regression_cuda(logits, planes),
                              lambda: regress_depth_and_confidence(logits.float(), planes),
                              iters=50, plain_iters=10, kernel="softmax_regression_kernel")
            k2_bound = bound(logits.numel() * 2 + planes.numel() * 4 + 2 * h * w * 4, 5 * logits.numel(), "f32")
            del logits
        log("cascade", f"stage {stage}: K1 per pixel [{V},{h},{w},{C}] bf16 + planes [{Dn},{h},{w}] f32 -> "
                       f"[{Dn},{h},{w},{C}] bf16 and f32: max|err| {k1_err:.3e} ({k1_over:.3f} x its limit); kernel "
                       f"{k1[0]:.4f} ms (device {fmt_ms(k1[3])}), plain {k1[1]:.4f} ms, bound "
                       f"{k1_bound['bound_ms']:.4f} ms ({k1_bound['bound_by']}). K2 per pixel on [1,{Dn},{h},{w}] "
                       f"bf16 logits: depth max|err| {k2['depth']:.3e} vs {k2['depth_tol']:.3e}, conf max|err| "
                       f"{k2['conf']:.3e} vs {REG_CONF_ATOL:.0e} ({k2['excluded']} pixels excluded near an integer "
                       f"index); kernel {k2_t[0]:.4f} ms (device {fmt_ms(k2_t[3])}), plain {k2_t[1]:.4f} ms, bound "
                       f"{k2_bound['bound_ms']:.4f} ms ({k2_bound['bound_by']})")
        if not (k1_over <= 1.0 and k2["depth"] <= k2["depth_tol"] and k2["conf"] <= REG_CONF_ATOL):
            failed.append(stage)
        common = {"route": "cuda", "case": f"CasMVSNet stage {stage}", "library_ms": None}
        rows += [
            {"name": "sweep_variance_per_pixel", **common,
             "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/sweep_variance.cu",
             "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/sweep_variance.py:607",
             "shape": f"[{V},{h},{w},{C}] bf16 + [{Dn},{h},{w}] f32 -> [{Dn},{h},{w},{C}] bf16",
             "max_abs_err": k1_err, "max_abs_err_over_tol": k1_over, "ms": k1[0], "device_ms": k1[3],
             "plain_ms": k1[1], **k1_bound, "library_none": NO_LIBRARY["sweep_variance"]},
            {"name": "softmax_regression_per_pixel", **common,
             "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/softmax_regression.cu",
             "replaces": "scene_3dreconstruction_mvsnet_tpu/ops/pallas/softmax_regression.py:86",
             "shape": f"[1,{Dn},{h},{w}] bf16 logits + [1,{Dn},{h},{w}] f32 -> 2x[1,{h},{w}] f32",
             "max_abs_err": k2["depth"], "tol": k2["depth_tol"], "conf_max_abs_err": k2["conf"],
             "conf_tol": REG_CONF_ATOL, "ms": k2_t[0], "device_ms": k2_t[3], "plain_ms": k2_t[1], **k2_bound,
             "library_none": NO_LIBRARY["softmax_regression"]},
        ]
    if failed:
        raise AssertionError(f"K1 or K2 per pixel disagrees with its plain version at CasMVSNet's stages {failed}")

    model = random_init_(find_model_def("casmvsnet")(dtype=bf16, ndepths=CAS_NDEPTHS,
                                                     depth_interval_ratio=CAS_RATIOS).to(dev), gen)
    infer = make_infer_step(model, dev)
    projs, dv = headline_rig(REF_CAMERAS[0])
    imgs = torch.randint(0, 256, (1, V, H, W, 3), generator=torch.Generator().manual_seed(SEED), dtype=torch.uint8)
    request = (imgs, torch.from_numpy(projs)[None], torch.from_numpy(dv)[None])
    infer(*request)  # warm: cuDNN's plans, the kernels' first launches
    dev_request = (imgs.to(dev).float() / 255.0, request[1].to(dev), request[2].to(dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            out = model(*dev_request)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    depth, conf = out["depth"], out["photometric_confidence"]
    # stages 2 and 3 may reach (N_s / 2) ratio_s intervals past the sweep's ends
    slack = sum(n / 2 * r for n, r in zip(CAS_NDEPTHS[1:], CAS_RATIOS[1:])) * (DEPTH_MAX - DEPTH_MIN) / D
    if not (tuple(depth.shape) == (1, H, W) and bool(torch.isfinite(depth).all()) and bool(torch.isfinite(conf).all())
            and DEPTH_MIN - slack <= depth.min().item() and depth.max().item() <= DEPTH_MAX + slack
            and 0.0 <= conf.min().item() and conf.max().item() <= 1.0 + 1e-5):
        raise AssertionError(f"CasMVSNet's bf16 forward gave bad maps: {tuple(depth.shape)}, depth "
                             f"[{depth.min().item()}, {depth.max().item()}], conf [{conf.min().item()}, "
                             f"{conf.max().item()}]")
    want = {"sweep_variance": 1, "sweep_variance_per_pixel": 2, "softmax_regression": 1,
            "softmax_regression_per_pixel": 2, "batch_norm_eval": 30, "prob_conv": 3}
    if counts != want:
        raise AssertionError(f"one CasMVSNet forward launched {counts}, not {want}")
    forward_ms = [cuda_time_ms(lambda: infer(*request), 1) for _ in range(CAS_FORWARDS)]
    log("cascade", f"bf16 CasMVSNet through make_infer_step at {V}x{H}x{W}, {'/'.join(map(str, CAS_NDEPTHS))} "
                   f"planes: one forward under set_sync_debug_mode('error') raised nothing; its launches {counts}; "
                   f"depth [{depth.min().item():.1f}, {depth.max().item():.1f}] mm; "
                   f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; a request "
                   f"(H2D, forward) {', '.join(f'{t:.2f}' for t in forward_ms)} ms "
                   f"(median {statistics.median(forward_ms):.2f})")
    for row in rows:
        row["launches"] = counts[row["name"]]
        row["launches_per"] = f"{counts[row['name']]} per request"
    return rows


def without_bn(counts: dict) -> dict:
    """The nonzero launch counts but the BatchNorm kernels': every 3D
    BatchNorm of the port launches them (phase 14 holds their counts)."""
    return {k: n for k, n in counts.items() if n and k not in BN_KERNELS}


def device_ms_per_call(fn, iters: int, names: tuple[str, ...]) -> float | None:
    """Device ms a call of ``fn``: the CUDA kernels whose names hold one of
    ``names``, summed over ``iters`` calls by torch.profiler (None where it
    saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.name for n in names)]
    return sum(spans) / 1e3 / iters if spans else None


def launches_of_each_model(gen, names: tuple[str, ...]) -> dict[str, dict[str, int]]:
    """The nonzero launches of the kernels ``names`` in one forward of each
    model, counted after a warm-up: a bf16 MVSNet eval forward at the
    headline, the same with K4, a bf16 CasMVSNet request, and one bf16 train
    step at the recipe (forward and backward), each with weights from
    ``gen``."""
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.infer import make_infer_step
    from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet, find_model_def, random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels
    from scene_3dreconstruction_mvsnet_tpu_torch.train import make_optimizer, make_scheduler, make_train_step

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    counts = {}
    projs, dv = headline_rig(REF_CAMERAS[0])
    imgs = torch.randint(0, 256, (1, V, H, W, 3), generator=torch.Generator().manual_seed(SEED), dtype=torch.uint8)
    request = (imgs, torch.from_numpy(projs)[None], torch.from_numpy(dv)[None])
    for tag, model in (("MVSNet eval", MVSNet(dtype=bf16)), ("MVSNet eval, K4", MVSNet(dtype=bf16, fused_conv0=True)),
                       ("CasMVSNet request", find_model_def("casmvsnet")(dtype=bf16, ndepths=CAS_NDEPTHS,
                                                                          depth_interval_ratio=CAS_RATIOS))):
        infer = make_infer_step(random_init_(model.to(dev), gen), dev)
        infer(*request)  # warm
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        infer(*request)
        torch.cuda.synchronize()
        counts[tag] = {k: n for k, n in kernels.launch_counts().items() if n and k in names}
        del model, infer
    model = random_init_(MVSNet(dtype=bf16).to(dev), gen)
    opt = make_optimizer(model, T_LR)
    step = make_train_step(model, opt, make_scheduler(opt, T_LREPOCHS, 1000), dev)
    batch = PlaneScene().batch()
    step(batch)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step(batch)
    torch.cuda.synchronize()
    counts["MVSNet train step"] = {k: n for k, n in kernels.launch_counts().items() if n and k in names}
    return counts


def phase_batchnorm(gen) -> list[dict]:
    """The BatchNorm3d + ReLU kernels (``ops/kernels/batch_norm.py``) at the
    cells' full-resolution volumes (BN_SHAPES, bf16, laid out NDHWC as
    CostRegNet holds them): the eval forward, the
    training forward (statistics and transform) and the backward, each held
    to the plain version (F.batch_norm with flax's running variance, then
    F.relu, and autograd through both) and timed beside it and beside
    ATen's BatchNorm alone (``library_ms``), with the device ms of its
    kernels and its bound (the volumes read once and written once); dgamma
    and dbeta against f64 sums of the same terms. Then the
    launches of one forward of each model: a bf16 MVSNet eval forward at the
    headline (10 eval launches, 9 with K4), one bf16 train step at the recipe
    (30 training and 30 backward launches) and a bf16 CasMVSNet request (30
    eval launches, phase 13's counts besides)."""
    import torch
    import torch.nn.functional as F

    from scene_3dreconstruction_mvsnet_tpu_torch.models import random_init_
    from scene_3dreconstruction_mvsnet_tpu_torch.models.blocks import BatchNorm3d
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import batch_norm as kbn
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import bf16_ulps

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    names = ("bn_transform_kernel", "bn_stats_", "bn_backward_")
    rows, failed = [], []
    ndhwc = torch.channels_last_3d  # CostRegNet's layout, the kernels' only one
    for shape in BN_SHAPES:
        bn = random_init_(BatchNorm3d(shape[1]).to(dev), gen)
        x = (torch.randn(shape, generator=gen, device=dev) * 1.7 + 0.4).to(bf16, memory_format=ndhwc)
        dy = torch.randn(shape, generator=gen, device=dev).to(bf16, memory_format=ndhwc)
        vol = x.numel() * x.element_size()
        rm, rv, w, b = bn.running_mean, bn.running_var, bn.weight.detach(), bn.bias.detach()
        case = "x".join(map(str, shape))

        bn.eval()
        with torch.no_grad():
            y, want = kbn.batch_norm_relu(bn, x, True), kbn.batch_norm_relu_plain(bn, x, True)
            eval_ulps = bf16_ulps(y, want, 1e-4 * want.float().abs().max().item())
            t = timed_pair(lambda: kbn.batch_norm_relu(bn, x, True), lambda: kbn.batch_norm_relu_plain(bn, x, True),
                           iters=20, plain_iters=20, kernel="bn_transform_kernel",
                           library_fn=lambda: F.batch_norm(x, rm, rv, w, b, False, 0.0, bn.eps))
        eval_row = {"pass": "eval", "ms": t[0], "plain_ms": t[1], "library_ms": t[2], "device_ms": t[3],
                    **bound(2 * vol, 0, "f32"), "max_ulps": eval_ulps}

        bn.train()
        with torch.no_grad():
            y, coef = kbn._forward(x, bn, True, keep_coef=True)
            want = kbn.batch_norm_relu_plain(bn, x, True)
            train_ulps = bf16_ulps(y, want, 1e-4 * want.float().abs().max().item())
            dims = (0, 2, 3, 4)
            x64 = x.double()
            mean64, var64 = x64.mean(dims), x64.var(dims, unbiased=False)
            stat_err = max(((coef[0].double() - mean64).abs() / (mean64.abs() + var64.sqrt())).max().item(),
                           ((coef[1].double() * (var64 + bn.eps).sqrt() - 1).abs()).max().item())
            del x64
            t = timed_pair(lambda: kbn.batch_norm_relu(bn, x, True), lambda: kbn.batch_norm_relu_plain(bn, x, True),
                           iters=20, plain_iters=20, kernel="bn_transform_kernel",
                           library_fn=lambda: F.batch_norm(x, None, None, w, b, True, 0.1, bn.eps))
            dev_ms = device_ms_per_call(lambda: kbn.batch_norm_relu(bn, x, True), 10, names)
        train_row = {"pass": "train", "ms": t[0], "plain_ms": t[1], "library_ms": t[2], "device_ms": dev_ms,
                     **bound(2 * vol, 0, "f32"), "max_ulps": train_ulps, "stats_rel_err": stat_err}

        # backward: the kernels from the saved x and coefficients; the plain
        # version autograd through F.batch_norm and F.relu; ATen's backward alone
        xg = x.detach().requires_grad_()
        wg, bg = bn.weight, bn.bias
        plain_y = kbn.batch_norm_relu_plain(bn, xg, True)
        mask = (y > 0).to(bf16)

        def plain_bwd():
            return torch.autograd.grad(plain_y, (xg, wg, bg), dy, retain_graph=True)

        _, save_mean, save_invstd = torch.ops.aten.native_batch_norm(x, w, b, None, None, True, 0.1, bn.eps)[:3]
        gm = (dy * mask).contiguous(memory_format=ndhwc)

        def library_bwd():
            return torch.ops.aten.native_batch_norm_backward(gm, x, w, None, None, save_mean, save_invstd, True,
                                                             bn.eps, [True, True, True])

        got = kbn._backward(x, dy, coef, True, True)
        ref = library_bwd()
        dx_ulps = bf16_ulps(got[0], ref[0], 1e-3 * ref[0].float().abs().max().item())
        # dgamma and dbeta against f64 sums of the same terms, over the sums of their sizes
        g64 = dy.double() * mask.double()
        xhat64 = (x.double() - mean64.view(-1, 1, 1, 1)) * (var64 + bn.eps).rsqrt().view(-1, 1, 1, 1)
        sums = ((g64 * xhat64).sum(dims), g64.sum(dims))
        sizes = ((g64 * xhat64).abs().sum(dims), g64.abs().sum(dims))
        del g64, xhat64
        dparam_err, aten_err = (max(((p.double() - w).abs() / n).max().item() for p, w, n in zip(ps, sums, sizes))
                                for ps in (got[1:], ref[1:]))
        again = kbn._backward(x, dy, coef, True, True)
        same_bits = all(torch.equal(a, c) for a, c in zip(got, again))
        t = timed_pair(lambda: kbn._backward(x, dy, coef, True, True), plain_bwd, iters=20, plain_iters=20,
                       kernel="bn_backward_dx_kernel", library_fn=library_bwd)
        dev_ms = device_ms_per_call(lambda: kbn._backward(x, dy, coef, True, True), 10, names)
        bwd_row = {"pass": "backward", "ms": t[0], "plain_ms": t[1], "library_ms": t[2], "device_ms": dev_ms,
                   **bound(3 * vol, 0, "f32"), "max_ulps": dx_ulps, "dparam_rel_err": dparam_err,
                   "library_dparam_rel_err": aten_err, "repeats_bits": same_bits}
        del xg, plain_y, gm, got, ref, again
        for row in (eval_row, train_row, bwd_row):
            log("batchnorm", f"{case} bf16 {row['pass']}: kernels {row['ms']:.4f} ms (device "
                             f"{fmt_ms(row['device_ms'])}), plain {row['plain_ms']:.4f} ms, ATen's BatchNorm alone "
                             f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
                             f"max {row['max_ulps']:.3f} bf16 ulps against "
                             f"{'ATen' if row['pass'] == 'backward' else 'the plain version'}"
                             + (f"; statistics within {stat_err:.2e} of f64" if row["pass"] == "train" else "")
                             + (f"; dgamma, dbeta within {dparam_err:.2e} of f64 x the sums of |terms| (ATen's "
                                f"{aten_err:.2e}); two runs {'equal' if same_bits else 'DIFFER'}"
                                if row["pass"] == "backward" else ""))
            rows.append({"name": f"batch_norm_{row.pop('pass')}", "route": "cuda", "case": case,
                         "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/batch_norm.cu",
                         "replaces": "none: flax's BatchNorm, compiled by XLA", "shape": f"[{case}] bf16", **row})
        if not (eval_ulps <= 1.0 and train_ulps <= 1.0 and stat_err <= 1e-5 and dx_ulps <= 2.0
                and dparam_err <= 1e-5 and same_bits):
            failed.append(case)
        del x, dy, y, want, coef, mask
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"the BatchNorm kernels disagree with their plain versions at {failed}")

    counts = launches_of_each_model(gen, BN_KERNELS)
    want = {"MVSNet eval": {"batch_norm_eval": 10}, "MVSNet eval, K4": {"batch_norm_eval": 9},
            "CasMVSNet request": {"batch_norm_eval": 30},
            "MVSNet train step": {"batch_norm_train": 30, "batch_norm_backward": 30}}
    log("batchnorm", "BatchNorm kernel launches of one forward: " + "; ".join(f"{k} {v}" for k, v in counts.items()))
    if counts != want:
        raise AssertionError(f"the BatchNorm kernels launched {counts}, not {want}")
    for row in rows:
        row["launches_per"] = {"batch_norm_eval": "1 per BatchNorm3d eval forward (10 per CostRegNet)",
                               "batch_norm_train": "3 per BatchNorm3d training forward (30 per train step)",
                               "batch_norm_backward": "3 per BatchNorm3d backward (30 per train step)"}[row["name"]]
    return rows


def phase_prob(gen) -> list[dict]:
    """CostRegNet's prob conv kernels (``ops/kernels/prob_conv.py``) at the
    cells' inputs (PROB_SHAPES, bf16, NDHWC): the forward and the backward, each
    held to the plain version (F.conv3d in f32 of the same inputs, TF32 off,
    and ``aten.convolution_backward`` of it) and timed beside it and beside
    cuDNN's bf16 conv and its backward (``library_ms``, what the port ran
    before; it never calls them now), with the device ms of its kernels and
    its bound (the input read once, the output written once, 216
    multiply-adds an output voxel a pass at the f32 rate). Then the launches
    of one forward of each model."""
    import torch

    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import bf16_ulps
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import prob_conv as kp

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    conv_bwd = torch.ops.aten.convolution_backward
    rows, failed = [], []
    for shape, has_bias in PROB_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev).to(bf16, memory_format=torch.channels_last_3d)
        w = (torch.randn((1, 8, 3, 3, 3), generator=gen, device=dev) * 0.2).to(bf16)
        b = (torch.randn((1,), generator=gen, device=dev) * 0.1).to(bf16) if has_bias else None
        xf, wf, bf = x.float(), w.float(), None if b is None else b.float()
        voxels = shape[0] * math.prod(shape[2:])
        case = "x".join(map(str, shape))

        with torch.no_grad():
            y, want = kp.prob_conv_cuda(x, w, b, 1), kp.prob_conv_plain(xf, wf, bf, 1)
            fwd_ulps = bf16_ulps(y, want, 1e-4 * want.abs().max().item())
            t = timed_pair(lambda: kp.prob_conv_cuda(x, w, b, 1), lambda: kp.prob_conv_plain(xf, wf, bf, 1),
                           iters=20, plain_iters=5, kernel="prob_forward_kernel",
                           library_fn=lambda: kp.prob_conv_plain(x, w, b, 1))
        fwd_row = {"pass": "forward", "ms": t[0], "plain_ms": t[1], "library_ms": t[2], "device_ms": t[3],
                   **bound(x.numel() * 2 + y.numel() * 2, 2 * 216 * voxels, "f32"), "max_ulps": fwd_ulps}

        g = torch.randn(y.shape, generator=gen, device=dev).to(bf16)
        gf = g.float()
        mask = [True, True, has_bias]

        def kernel_bwd():
            return kp._backward(x, w, g, 1, True, True, has_bias)

        def plain_bwd():
            return conv_bwd(gf, xf, wf, [1] if has_bias else None, [1] * 3, [1] * 3, [1] * 3, False, [0] * 3, 1, mask)

        def library_bwd():
            return conv_bwd(g, x, w, [1] if has_bias else None, [1] * 3, [1] * 3, [1] * 3, False, [0] * 3, 1, mask)

        got, ref = kernel_bwd(), plain_bwd()
        dx_ulps = bf16_ulps(got[0], ref[0], 1e-4 * ref[0].abs().max().item())
        # the weight and bias gradients, rounded to bf16 once, against f32 sums over every voxel
        dparam_err = max(((a.float() - r).abs().max() / r.abs().max()).item()
                         for a, r in zip(got[1:], ref[1:]) if a is not None)
        same_bits = all(torch.equal(a, c) for a, c in zip(got, kernel_bwd()) if a is not None)
        t = timed_pair(kernel_bwd, plain_bwd, iters=20, plain_iters=5, kernel="prob_dgrad_kernel",
                       library_fn=library_bwd)
        dev_ms = device_ms_per_call(kernel_bwd, 10, ("prob_dgrad_kernel", "prob_wgrad"))
        bwd_row = {"pass": "backward", "ms": t[0], "plain_ms": t[1], "library_ms": t[2], "device_ms": dev_ms,
                   **bound(g.numel() * 2 + 2 * x.numel() * 2, 2 * 2 * 216 * voxels, "f32"), "max_ulps": dx_ulps,
                   "dparam_rel_err": dparam_err, "repeats_bits": same_bits}
        for row in (fwd_row, bwd_row):
            log("prob", f"{case} bf16 {'bias' if has_bias else 'no bias'} {row['pass']}: kernels {row['ms']:.4f} ms "
                        f"(device {fmt_ms(row['device_ms'])}), plain f32 {row['plain_ms']:.4f} ms, cuDNN bf16 "
                        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); max "
                        f"{row['max_ulps']:.3f} bf16 ulps against the plain version"
                        + (f"; dweight, dbias within {dparam_err:.2e} of the largest; two runs "
                           f"{'equal' if same_bits else 'DIFFER'}" if row["pass"] == "backward" else ""))
            rows.append({"name": f"prob_conv{'_backward' if row.pop('pass') == 'backward' else ''}", "route": "cuda",
                         "case": case, "source": "scene_3dreconstruction_mvsnet_tpu_torch/csrc/prob_conv.cu",
                         "replaces": "none: CostRegNet's prob conv, left to XLA", "shape": f"[{case}] bf16", **row})
        if not (fwd_ulps <= 1.0 and dx_ulps <= 1.0 and dparam_err <= 2.0 ** -7 and same_bits):
            failed.append(case)
        del x, xf, y, want, g, gf, got, ref
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"the prob conv kernels disagree with their plain versions at {failed}")

    counts = launches_of_each_model(gen, PROB_KERNELS)
    want = {"MVSNet eval": {"prob_conv": 1}, "MVSNet eval, K4": {"prob_conv": 1}, "CasMVSNet request": {"prob_conv": 3},
            "MVSNet train step": {"prob_conv": 1, "prob_conv_backward": 3}}
    log("prob", "prob conv kernel launches of one forward: " + "; ".join(f"{k} {v}" for k, v in counts.items()))
    if counts != want:
        raise AssertionError(f"the prob conv kernels launched {counts}, not {want}")
    for row in rows:
        row["launches_per"] = {"prob_conv": "1 per CostRegNet forward (3 per cascade request)",
                               "prob_conv_backward": "3 per CostRegNet backward (3 per train step)"}[row["name"]]
    return rows


def near_integer_index(depth_plain, depth_diff, depth_values=None):
    """Pixels where the truncated expected plane index may legitimately differ
    between two paths: the plain path's expected index (linear in depth, as
    the hypotheses are evenly spaced) lies within the two paths' measured
    disagreement plus INT_BAND of an integer. ``depth_values`` [B, D] are
    each sample's hypotheses, [B, D, h, w] each pixel's (evenly spaced per
    pixel, as the cascade's); default: the headline's."""
    if depth_values is None:
        lo, per_depth = DEPTH_MIN, (D - 1) / (DEPTH_MAX - DEPTH_MIN)
    elif depth_values.dim() == 4:
        lo = depth_values[:, 0]
        per_depth = (depth_values.shape[1] - 1) / (depth_values[:, -1] - lo)
    else:
        lo = depth_values[:, :1, None]
        per_depth = (depth_values.shape[1] - 1) / (depth_values[:, -1:, None] - lo)
    e_idx = (depth_plain - lo) * per_depth
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
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import reset_launch_counts

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
    reset_launch_counts()
    outputs, seconds = {}, {}
    for tag, step in steps.items():
        outputs[tag], seconds[tag] = [], []
        for imgs, proj, dv in requests:
            t0 = time.perf_counter()
            out = step(imgs, proj, dv)
            torch.cuda.synchronize()
            seconds[tag].append(time.perf_counter() - t0)
            outputs[tag].append(out)
    launches = launches_of("sweep_variance", "softmax_regression")
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
    # K1-emit, K3-terms and K3 on the training path; --remat and the prefetched input
    train_launches, plain_step_s, initial, remat = phase_train(gen)
    launches.update(train_launches)
    eval_launches, scan_maps = phase_eval(repo)  # K4 and K5 on the eval CLI's path; --img_cache
    launches.update(eval_launches)
    extra = phase_dtu(repo, gen)  # K1 and K2 on evalDTU.py's legacy path, f32 at 1184x1600
    for more in (remat, phase_train_extras(repo, gen, plain_step_s),  # refine, dumps (K5), profile
                 phase_parallel(repo, gen, initial, plain_step_s, scan_maps),  # gloo, NCCL, sharded stage A and B
                 phase_api(gen, scan_maps),  # geometric_filter_stack, Hourglass3d
                 phase_sweep(repo, gen, initial)):  # the depth planes split over 2 and over 2x2 gloo ranks
        for kernel, fields in more.items():
            extra.setdefault(kernel, {}).update(fields)
    for row in rows:
        n, units, unit = launches[row["name"]]
        row["launches"] = n
        row["launches_per"] = f"{n / units:g} per {unit}"
        row.update(extra.get(row["name"], {}))
    rows += phase_recipes(repo, gen)  # the five presets through the runner, and the kernels at their shapes
    rows += phase_cascade(gen)  # K1 and K2 per pixel at CasMVSNet's stages 2 and 3, and its forward's launches
    rows += phase_batchnorm(gen)  # the BatchNorm3d + ReLU kernels, and their launches in each model
    rows += phase_prob(gen)  # CostRegNet's prob conv kernels, and their launches in each model

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "scene_3dreconstruction_mvsnet_tpu"))
    if leaked:
        raise AssertionError(f"the port pulled in JAX or the JAX package: {leaked[:5]}")

    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
