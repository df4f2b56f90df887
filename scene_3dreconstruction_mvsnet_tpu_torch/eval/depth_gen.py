"""Eval stage A: a depth map for every reference view.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/eval/depth_gen.py::
save_depth``: MVSNet runs on each reference view of the eval dataset and
the output tree

    <outdir>/<acquisition>/<scan>/images/XXXXXXXX.png
                                 /depth_est/XXXXXXXX.pfm (+ .png preview)
                                 /confidence/XXXXXXXX.pfm (+ .png preview)
                                 /cams/XXXXXXXX_cam.txt

is written by a pool of writer threads while the device computes. The
datasets, the loader and the codecs are the port's own (``data``, ``io``:
numpy and Pillow); the images stay u8 until the device divides them by 255,
and each batch is staged in pinned memory and copied to the card a batch
ahead (``data.prefetch_to_device``). ``data_shards`` splits each batch over
that many devices (``parallel.make_sharded_infer``) and ``img_cache`` reads
the images through the decoded-image cache, as in the JAX package.
Not ported, because they exist for the TPU and its host link: the
sweep envelope planner, the device image store, the D2H warm-up and the
compiled-executable cache.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data import Loader, find_dataset_def, prefetch_to_device
from ..geometry.transforms import depth_to_world_points
from ..infer import make_infer_step
from ..parallel import local_devices, make_sharded_infer
from ..io.cams import write_cam
from ..io.images import resize_img, save_image_u8
from ..io.pfm import save_pfm
from ..io.ply import write_ply
from ..utils.misc import get_powers


def _normalize01(x: np.ndarray) -> np.ndarray:
    lo, hi = np.min(x), np.max(x)
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def _write_view(outdir_acq, filename_tpl, ref_img, depth, confidence, K, E) -> None:
    paths = {kind: os.path.join(outdir_acq, filename_tpl.format(kind, ext)) for kind, ext in (
        ("images", ".png"), ("depth_est", ".pfm"), ("confidence", ".pfm"), ("cams", "_cam.txt"))}
    for p in paths.values():
        os.makedirs(os.path.dirname(p), exist_ok=True)
    save_image_u8(paths["images"], ref_img)
    save_pfm(paths["depth_est"], depth.astype(np.float32))
    save_image_u8(paths["depth_est"].replace(".pfm", ".png"), _normalize01(depth))
    save_pfm(paths["confidence"], confidence.astype(np.float32))
    save_image_u8(paths["confidence"].replace(".pfm", ".png"), np.clip(confidence, 0, 1))
    write_cam(paths["cams"], K=K, R=E, depth_params=["000", "2.5", "", ""])


def _dump_depth_gen_debug(debug_dir, view, bits, ref_img, depth, confidence) -> None:
    """``--debug_depth_gen`` bits 0 (the input image) and 1 (depth and
    confidence PNGs), headless."""
    os.makedirs(debug_dir, exist_ok=True)
    if "0" in bits:
        ref_img = np.asarray(ref_img)
        save_image_u8(os.path.join(debug_dir, f"input_view{view:0>4}.png"),
                      ref_img if ref_img.dtype == np.uint8 else np.clip(ref_img, 0, 1))
    if "1" in bits:
        save_image_u8(os.path.join(debug_dir, f"depth_est_view{view:0>4}.png"), _normalize01(depth))
        save_image_u8(os.path.join(debug_dir, f"confidence_view{view:0>4}.png"), np.clip(confidence, 0, 1))
        save_image_u8(os.path.join(debug_dir, f"confidence_gt50_view{view:0>4}.png"),
                      np.clip(confidence * (confidence > 0.5), 0, 1))


def auto_depth_chunk(img_res: tuple[int, int], numdepth: int, budget_elems: int = 100_000_000,
                     batch_size: int = 1) -> int | None:
    """The plain sweep's depth chunk that bounds each chunk's warped volumes
    to ``budget_elems`` elements (B * Dc * h/4 * w/4 * 32): the largest
    divisor of ``numdepth`` within the budget, or None when all planes fit.
    The JAX package's ``auto_depth_chunk``; chunking is exact (the variance
    is independent per plane), and the sweep kernel ignores it."""
    h4 = (img_res[0] // 32) * 8  # the datasets crop to a multiple of 32; features are /4
    w4 = (img_res[1] // 32) * 8
    dc = max(1, budget_elems // (batch_size * h4 * w4 * 32))
    if dc >= numdepth:
        return None
    return next(c for c in range(dc, 0, -1) if numdepth % c == 0)


def save_depth(
    model,
    *,
    dataset: str,
    dataset_name: str,
    testpath: str,
    testlist: str,
    outdir: str,
    NviewGen: int = 5,
    numdepth: int = 192,
    interval_scale: float = 1.06,
    pairfile: str = "pair.txt",
    cam_subfolder: str = "Cameras",
    img_subfolder: str = "Rectified/{}/{:0>8}.png",
    img_res: tuple[int, int] = (512, 640),
    num_workers: int = 4,
    debug_bitmask: int = 0,
    debug_depth_gen: int = 0,
    batch_size: int = 1,
    on_scan_done=None,
    data_shards: int = 1,
    img_cache: str | None = None,
    device: torch.device | str = "cuda",
) -> dict:
    """Depth and confidence for every reference view, with ``model`` (an
    MVSNet with its weights) on ``device``. Returns timing stats: the
    phases' host seconds (the forward split into ``launch``, the host
    queueing it, and ``device_wait``, the host waiting for its results) and,
    on a card, each batch's ``device_ms`` from CUDA events around the forward
    (from its first kernel's start to its last one's end, idle gaps included);
    ``device_busy_frac``, the sum of the forward spans over stage A's wall
    (the spans from the host clock on the CPU, launch to results). A span
    counts the idle gaps inside the forward as busy; the spans follow one
    another inside stage A, so a share above 1 means a miscount, and it is
    reported as it is.

    ``batch_size`` > 1 batches reference views; the trailing partial batch
    is padded by repeating its last view (the padding is not written).
    ``data_shards`` > 1 splits each batch over the first ``data_shards``
    devices of ``device``'s type (``batch_size`` must be a multiple);
    ``img_cache`` is a directory for the decoded-image cache.
    ``on_scan_done(scan)`` is called, in scan order from one thread, once a
    scan's last view is written. ``debug_bitmask`` dumps the first batch's
    forward stages (``utils/debug_dump.py``); ``debug_depth_gen`` is the
    reference's bitmask as headless dumps under
    ``<outdir>/<acquisition>/debug_depth_gen/``: bit 0 input image, bit 1
    depth and confidence PNGs, bit 2 per-view cloud PLY, bit 3 the combined
    cloud PLY and its post-processed variant."""
    print(f"============ Generating DEPTH MAPS using {NviewGen} views")
    phases: dict[str, float] = {}
    t_phase = time.time()

    def mark(name: str) -> None:
        nonlocal t_phase
        now = time.time()
        phases[name] = phases.get(name, 0.0) + (now - t_phase)
        t_phase = now

    device = torch.device(device)
    if data_shards > 1:
        if batch_size % data_shards:
            raise ValueError(f"batch_size {batch_size} must be a multiple of data_shards {data_shards}")
        devices = local_devices(data_shards, device)
        device = devices[0]
        infer = make_sharded_infer(model, devices)
    else:
        infer = make_infer_step(model, device)
    test_dataset = find_dataset_def(dataset)(
        datapath=testpath, listfile=testlist, mode="test", nviews=NviewGen, ndepths=numdepth,
        interval_scale=interval_scale, pairfile=pairfile, cam_subfolder=cam_subfolder,
        img_subfolder=img_subfolder, img_res=img_res, dataset_name=dataset_name, img_cache=img_cache,
        emit_u8=True,  # u8 end to end (dataloader_eval honours it; the legacy readers emit f32)
    )
    mark("dataset_init")
    loader = Loader(test_dataset, batch_size=batch_size, num_workers=num_workers)

    def pad(sample: dict) -> dict:
        """The trailing partial batch repeats its last view (on the producer
        thread); ``n_real`` counts the views to write."""
        sample["n_real"] = n_real = sample["imgs"].shape[0]
        if n_real < batch_size:
            for k in ("imgs", "proj_matrices", "depth_values"):
                a = sample[k]
                sample[k] = np.concatenate([a, np.repeat(a[-1:], batch_size - n_real, 0)])
        return sample

    acquisition_folder = testpath.rstrip("/").split("/")[-1]
    outdir_acq = os.path.join(outdir, acquisition_folder)
    gen_bits = set(get_powers(debug_depth_gen))
    debug_dir = os.path.join(outdir_acq, "debug_depth_gen")
    accumulate_cloud = bool({"2", "3"} & gen_bits)  # the clouds are kept only for these dumps
    vertices: list[np.ndarray] = []
    vertex_colors: list[np.ndarray] = []

    gen_times: list[float] = []  # per view: the time between successive batches' results / views
    device_ms: list[float] = []  # per batch, on a card
    host_spans: list[float] = []  # per batch, off a card: launch to results on the host clock
    first_batch_views = 0  # views of batch 0, whose time carries the first launches
    writer = ThreadPoolExecutor(max_workers=2)
    pending = []
    view_idx = 0
    n_views_total = len(test_dataset)

    # per-scan completion: once a scan's last view is emitted and its files
    # are flushed, on_scan_done fires (the CLI filters finished scans while
    # later scans generate depth); one notifier thread keeps scan order
    scan_views_left: dict[str, int] = {}
    scan_futures: dict[str, list] = {}
    notifier = None
    if on_scan_done is not None:
        for meta in test_dataset.metas:
            scan_views_left[meta[0]] = scan_views_left.get(meta[0], 0) + 1
        notifier = ThreadPoolExecutor(max_workers=1)

    def view_done(scan: str, write_future) -> None:
        if on_scan_done is None or scan not in scan_views_left:
            return
        scan_futures.setdefault(scan, []).append(write_future)
        scan_views_left[scan] -= 1
        if scan_views_left[scan] == 0:
            futs = scan_futures.pop(scan)

            def flush_then_notify(scan=scan, futs=futs):
                for f in futs:
                    f.result()
                on_scan_done(scan)

            pending.append(notifier.submit(flush_then_notify))

    def emit_batch(sample, n_real, depths, confidences, dt) -> None:
        nonlocal view_idx
        K_b, E_b = sample.get("intrinsics"), sample.get("extrinsics")
        if K_b is None:
            raise ValueError("eval dataset must return intrinsics/extrinsics (use dataset='dataloader_eval')")
        for b in range(n_real):
            depth, confidence = depths[b], confidences[b]
            view_idx += 1
            print(f"Iter {view_idx}/{n_views_total} (fwd pass in {dt / n_real:.3f}s)")
            print("depth Min/Max: {:.1f}/{:.1f} - conf. Min/Max: {:.1f}%/{:.1f}%".format(
                np.min(depth), np.max(depth), np.min(confidence) * 100, np.max(confidence) * 100))
            print("confidence percentiles: 25%:{:.1f}% 50%:{:.1f}% 75%:{:.1f}% 90%:{:.1f}%".format(
                *(np.percentile(confidence, q) * 100 for q in (25, 50, 75, 90))))
            filename_tpl = sample["filename"][b]
            ref_img = sample["imgs"][b, 0]
            wf = writer.submit(_write_view, outdir_acq, filename_tpl, ref_img, depth, confidence,
                               K_b[b][0], E_b[b][0])
            pending.append(wf)
            view_done(filename_tpl.split("/")[0], wf)
            if gen_bits:
                _dump_depth_gen_debug(debug_dir, view_idx - 1, gen_bits, ref_img, depth, confidence)
            if accumulate_cloud:
                world = depth_to_world_points(
                    torch.from_numpy(depth.astype(np.float32)),
                    torch.as_tensor(np.asarray(K_b[b][0]), dtype=torch.float32),
                    torch.as_tensor(np.asarray(E_b[b][0]), dtype=torch.float32),
                    xy_scale=1.0,
                ).numpy()
                colors = resize_img(np.asarray(ref_img), depth.shape).reshape(-1, 3)
                vertices.append(world)
                vertex_colors.append((np.clip(colors, 0, 1) * 255).astype(np.uint8))
                if "2" in gen_bits:
                    write_ply(os.path.join(debug_dir, f"cloud_view{view_idx - 1:0>4}.ply"), world, vertex_colors[-1])

    last_done = None
    mark("pre_loop")
    for batch_idx, (sample, on_device) in enumerate(prefetch_to_device(loader, device, transform=pad)):
        mark("loader_wait")
        if batch_idx == 0 and debug_bitmask:
            from ..utils.debug_dump import debug_forward

            debug_forward(model, sample["imgs"], sample["proj_matrices"], sample["depth_values"], debug_bitmask,
                          outdir_acq)
            mark("debug_dump")
        n_real = sample["n_real"]
        if batch_idx == 0:
            first_batch_views = n_real
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if device.type == "cuda" else None
        t0 = time.time()
        if events:
            events[0].record()
        outputs = infer(on_device["imgs"], on_device["proj_matrices"], on_device["depth_values"])
        if events:
            events[1].record()
        mark("launch")
        depths = outputs["depth"].cpu().numpy()  # waits for the device
        confidences = outputs["photometric_confidence"].cpu().numpy()
        now = time.time()
        dt = now - (last_done if last_done is not None else t0)
        last_done = now
        gen_times.extend([dt / n_real] * n_real)
        mark("device_wait")
        if events:
            device_ms.append(events[0].elapsed_time(events[1]))
        else:
            host_spans.append(now - t0)
        emit_batch(sample, n_real, depths, confidences, dt)
        mark("emit")
    for f in pending:
        f.result()
    writer.shutdown()
    if notifier is not None:
        notifier.shutdown()
    mark("writer_drain")

    print("stage A phases (s): " + " ".join(f"{k}={v:.2f}" for k, v in phases.items()))
    device_busy_frac = None
    stage_a_wall = sum(phases.values())
    spans = [ms / 1e3 for ms in device_ms] or host_spans
    if spans and stage_a_wall > 0:
        device_busy_frac = sum(spans) / stage_a_wall
        print(f"device busy: {sum(spans):.3f} s of forward spans ({'CUDA events' if device_ms else 'host clock'}; "
              f"idle gaps inside a forward count as busy) over {len(spans)} batches / stage A = "
              f"{device_busy_frac:.1%}")

    if accumulate_cloud and vertices:
        all_pts, all_cols = np.concatenate(vertices), np.concatenate(vertex_colors)
        print("Combining ALL 3D Pts-clouds.\n")
        if "3" in gen_bits:
            from .scene_kit import get_frame_bbox, postprocess_cloud

            write_ply(os.path.join(debug_dir, "cloud_allviews.ply"), all_pts, all_cols)
            _, outer = get_frame_bbox(context=acquisition_folder)
            pts, cols = postprocess_cloud(all_pts, all_cols, crop_bbox=None if dataset_name == "dtu" else outer,
                                          voxel_size=5.0)
            write_ply(os.path.join(debug_dir, "cloud_allviews_post.ply"), pts, cols)

    avg = float(np.mean(gen_times)) if gen_times else 0.0
    tail = gen_times[first_batch_views:]  # the steady state leaves out the first batch
    steady = float(np.mean(tail)) if tail else avg
    print(f"Averaged generation time: {avg}")
    print(f"steady_gen_time: {steady}")
    return {
        "avg_gen_time": avg,
        "steady_gen_time": steady,
        "n_views": len(gen_times),
        "device_ms": device_ms,
        "device_busy_frac": device_busy_frac,
        "outdir_acq": outdir_acq,
        "phases": phases,
    }
