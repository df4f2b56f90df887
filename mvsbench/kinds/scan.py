"""Scan traffic: one client in a closed loop on the eval CLI's serve loop.

Set-up writes a tree of the bin registry (``scenes.write_scan_tree``: a
pool of scans of the configuration's ring made from the seed, PNG images)
and a checkpoint of weights made from the seed, then starts one
``eval_cli --serve`` process (``mvsbench/serve_child.py``) at the
configuration's eval and filter settings and serves ``warm`` requests that
are not counted. In the window the client writes a fresh scan name, whose
directory holds hard links to a pool scan's images (no path repeats and
nothing is copied), and waits for the scan's ``SERVED`` line: its depth maps,
masks and PLY written. ``scan_p90_s`` is the 90th percentile of those
latencies over every scan of the window.

The program's own lines of each request are the per-layer spans: stage A's
phases, the forward's device-busy seconds, and the ``SERVED`` seconds.

Every scan's outputs stay on disk, as the eval CLI leaves them, until the
window has closed; the harness deletes them after the check.

Correctness, on a sample of the window's scans drawn from the seed once the
window has closed: stage A against the plain f32 reference forward on the
same image files (the mean absolute depth error over the depth range and
the mean absolute confidence error, each over the error of the reference in
the precision below the configuration's, the cell's ``control``, on the
same views: how far rounding moves the stereo's answers differs from seed
to seed by far more than the precisions differ, and the control's error on
the seed's own views is the scale that moves with it); stage B by the plain
filter and fusion run on the program's own depth and confidence files (the
share of mask pixels that differ over the photo, geo and final masks, and
the distance between a PLY point and the reference's point of the same
pixel, over the depth range). ``scan_errors`` gives them; the workload
file's ``limits`` name the ones compared.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from .. import scenes
from ..core import Check, Ctx, Outcome, percentile
from ..reference import files
from ..reference import fusion as ref_fusion
from ..reference import mvsnet as ref_mvsnet
from ..reference.precision import exact, rounding
from ..weights import make_state_dict, stereo_weights

READY_TIMEOUT_S = 900  # the serve process's start; a first run in a checkout builds the kernels
REQUEST_TIMEOUT_S = 120
CHILD_MODULE = "mvsbench.serve_child"  # the module the serve process runs
PHASES = re.compile(r"^stage A phases \(s\): (.*)$")
BUSY = re.compile(r"^device busy: ([0-9.]+) s of forward spans")
SERVED = re.compile(r"^SERVED (\S+): (\d+) views in ([0-9.]+)s")


class Child:
    """The serve process, its stdout read on a thread into a queue."""

    def __init__(self, argv: list[str], cwd: str, log_path: str, env: dict):
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen([sys.executable, "-m", CHILD_MODULE, *argv], cwd=cwd, env=env,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log, text=True,
                                     bufsize=1)
        self.lines: queue.Queue = queue.Queue()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line.rstrip("\n"))
        self.lines.put(None)

    def send(self, text: str) -> None:
        self.proc.stdin.write(text + "\n")
        self.proc.stdin.flush()

    def until(self, pattern: str, timeout: float) -> list[str]:
        """The lines up to and with the first that starts with ``pattern``."""
        seen, deadline = [], time.monotonic() + timeout
        while True:
            line = self.lines.get(timeout=max(0.0, deadline - time.monotonic()))
            if line is None:
                raise RuntimeError(f"the serve process ended before {pattern!r}: {seen[-20:]}")
            seen.append(line)
            if line.startswith(pattern):
                return seen

    def close(self) -> list[str]:
        """Ends the serve loop and the process; returns its last lines."""
        rest = []
        try:
            if self.proc.poll() is None:
                self.send("quit")
                self.proc.stdin.close()
            while (line := self.lines.get(timeout=120)) is not None:
                rest.append(line)
            self.proc.wait(timeout=60)
        except (queue.Empty, subprocess.TimeoutExpired, BrokenPipeError):
            self.proc.kill()
            self.proc.wait()
        finally:
            self.reader.join(timeout=10)
            self.log.close()
        return rest


def scan_weights(config: dict, seed: int, device, tree: dict) -> dict:
    """The configuration's weights from the seed: ``weights.stereo`` lays
    the plane-sweep stereo of ``weights.stereo_weights`` over the random
    draw (its sharpness set on the first pool scan's images), so that the
    filter finds consistent pixels and the PLY has points."""
    w = config.get("weights", {})
    template = ref_mvsnet.MVSNet().state_dict()
    if "stereo" not in w:
        return make_state_dict(template, seed, device)
    images = torch.as_tensor(np.stack([files.read_png(os.path.join(tree["pool"][0], f))
                                       for f in sorted(os.listdir(tree["pool"][0]))]))
    return stereo_weights(template, seed, device, images, **w["stereo"])


def serve_argv(ctx: Ctx, tree: dict, ckpt: str, outdir: str) -> list[str]:
    s, f = ctx.config["eval"], ctx.config["filter"]
    argv = ["--dataset", "dataloader_eval", "--dataset_name", s["registry"], "--testpath", tree["testpath"],
            "--loadckpt", ckpt, "--outdir", outdir, "--NviewGen", str(s["views"]), "--numdepth", str(s["numdepth"]),
            "--interval_scale", str(s["interval_scale"]), "--NviewFilter", str(f["NviewFilter"]),
            "--photomask", str(f["photomask"]), "--geomask", str(f["geomask"]),
            "--condmask_pixel", str(f["condmask_pixel"]), "--condmask_depth", str(f["condmask_depth"]),
            "--img_res", str(s["img_hw"][0]), str(s["img_hw"][1]), "--dtype", s["dtype"], "--serve",
            "--device", ctx.device.type]
    return argv + (["--save_ply"] if f["save_ply"] else [])


def link_scan(tree: dict, pool_index: int, name: str) -> None:
    src = tree["pool"][pool_index]
    dst = os.path.join(tree["testpath"], "Rectified", name)
    os.makedirs(dst)
    for fname in sorted(os.listdir(src)):
        os.link(os.path.join(src, fname), os.path.join(dst, fname))


def parse_request(lines: list[str]) -> dict:
    out = {}
    for line in lines:
        if m := PHASES.match(line):
            out["phases_s"] = {k: float(v) for k, v in (kv.split("=") for kv in m.group(1).split())}
        elif m := BUSY.match(line):
            out["busy_s"] = float(m.group(1))
        elif m := SERVED.match(line):
            out["views"], out["served_s"] = int(m.group(2)), float(m.group(3))
    return out


def run(ctx: Ctx) -> Outcome:
    s, tr, dev = ctx.config["eval"], ctx.traffic, ctx.device
    checkout = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tree_root, outdir = os.path.join(ctx.work_dir, "tree"), os.path.join(ctx.work_dir, "out")
    for d in (tree_root, outdir):
        shutil.rmtree(d, ignore_errors=True)
    tree = scenes.write_scan_tree(tree_root, ctx.seed, tr, s, dev)
    state = {k: v.cpu() for k, v in scan_weights(ctx.config, ctx.seed, dev, tree).items()}
    ckpt = os.path.join(ctx.work_dir, "model.ckpt")
    torch.save({"model": {"module." + k: v for k, v in state.items()}}, ckpt)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    child = Child(serve_argv(ctx, tree, ckpt, outdir), checkout, os.path.join(ctx.work_dir, "serve.log"),
                  dict(os.environ))
    served: list[dict] = []
    failed, trace, closing = 0, None, []
    try:
        child.until("SERVE ready", READY_TIMEOUT_S)
        for i in range(tr["warm"]):
            name = f"warm{9001 + i}"  # its PLY's number is no window scan's
            link_scan(tree, i % len(tree["pool"]), name)
            child.send(name)
            child.until(f"SERVED {name}:", READY_TIMEOUT_S)
        raw, reduced = os.path.join(ctx.work_dir, "trace_raw.json"), os.path.join(ctx.work_dir, "trace.json")
        if ctx.trace:
            child.send(f"#mvsbench trace start {raw}")
            child.until("MVSBENCH trace started", 60)
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        while time.perf_counter() - t0 < ctx.seconds:
            n = len(served) + 1
            name, pool_index = f"scan{n}", (n - 1) % len(tree["pool"])
            link_scan(tree, pool_index, name)
            t = time.perf_counter()
            child.send(name)
            try:
                lines = child.until(f"SERVED {name}:", REQUEST_TIMEOUT_S)
            except queue.Empty:
                failed += 1
                break
            served.append({"name": name, "pool": pool_index, "latency_s": time.perf_counter() - t,
                           **parse_request(lines)})
        window = time.perf_counter() - t0
        if ctx.trace:
            child.send(f"#mvsbench trace stop {reduced}")
            child.until("MVSBENCH trace written", 300)
            with open(reduced) as fh:
                trace = json.load(fh)
    finally:
        closing = child.close()
    peak = next((int(line.split()[-1]) for line in closing if line.startswith("MVSBENCH peak")), 0)
    found = next((line.split(" ", 2)[2] for line in closing if line.startswith("MVSBENCH modules")), "[]")
    if found != "[]":
        raise RuntimeError(f"the serve process loaded {found}")

    rng = np.random.default_rng([ctx.seed, 5])
    sample = [served[i] for i in sorted(rng.choice(len(served), size=min(tr["checked"], len(served)),
                                                   replace=False).tolist())]
    numbers = check_scans(ctx, tree, outdir, state, sample)
    limits = ctx.workload["limits"]
    checks = [Check(k, numbers[k], limits[k]) for k in limits]
    latencies = [r["latency_s"] for r in served]
    ctx.log(f"checked {[r['name'] for r in sample]}: {numbers}; latency s: median "
            f"{percentile(latencies, 50):.4f} p90 {percentile(latencies, 90):.4f} max {max(latencies):.4f}")
    shutil.rmtree(outdir, ignore_errors=True)

    record = {"scans": served, "window_s": window, "trace": trace, "numbers": numbers}
    return Outcome(e2e={"scan_p90_s": percentile(latencies, 90), "setup_s": setup_s}, record=record,
                   checks=checks, attempted=len(served) + failed, failed=failed, memory_peak_bytes=peak,
                   trace=trace)


def scan_views(tree: dict, pool_index: int, setting: dict) -> list[dict]:
    """The requests of one scan as the eval loader reads them, one per
    reference view in the pair file's order: images [1, V, H, W, 3] u8 from
    the PNG files, projections at feature resolution, the planes."""
    pairs = files.read_pairs(os.path.join(tree["root"], "pair.txt"))
    cams = [files.read_cam(os.path.join(tree["testpath"], "Cameras", f"{v:0>8}_cam.txt"))
            for v in range(tree["n_cams"])]
    scale = setting["interval_scale"]
    out = []
    for ref, srcs in pairs:
        views = [ref] + srcs[: setting["views"] - 1]
        imgs = np.stack([files.read_png(os.path.join(tree["pool"][pool_index], f"00000{v:0>3}.png")) for v in views])
        proj = scenes.feature_proj(np.stack([cams[v][0] for v in views]), np.stack([cams[v][1] for v in views]))
        planes = scenes.depth_hypotheses(cams[ref][2], cams[ref][3] * scale, setting["numdepth"])
        out.append({"ref": ref, "imgs": imgs[None], "proj_matrices": proj[None], "depth_values": planes[None]})
    return out


def stage_b(tree: dict, depths: dict, confs: dict, filt: dict, device, control: str | None = None) -> dict:
    """The plain filter and fusion of one scan's maps (keyed by view) ->
    per reference view its masks and fused points [H*W, 3]."""
    pairs = files.read_pairs(os.path.join(tree["root"], "pair.txt"))
    cams = {v: files.read_cam(os.path.join(tree["testpath"], "Cameras", f"{v:0>8}_cam.txt"))
            for v in range(tree["n_cams"])}
    Ks = {v: np.diag([0.25, 0.25, 1.0]) @ c[0] for v, c in cams.items()}
    Es = {v: c[1] for v, c in cams.items()}
    fn = rounding(control)
    if fn is not None:
        depths = {v: fn(torch.as_tensor(d)).numpy() for v, d in depths.items()}
        confs = {v: fn(torch.as_tensor(c)).numpy() for v, c in confs.items()}
    out = {}
    for ref, srcs in pairs:
        r = ref_fusion.filter_view(depths, confs, Ks, Es, ref, srcs[: filt["NviewFilter"]],
                                   photomask=filt["photomask"], geomask=filt["geomask"],
                                   condmask_pixel=filt["condmask_pixel"], condmask_depth=filt["condmask_depth"],
                                   device=device)
        r["points"] = ref_fusion.back_project(r["fused"], Ks[ref], Es[ref], filt["xy_scale"], device)
        out[ref] = r
    return out


def program_scan(tree: dict, folder: str, ply: str) -> dict:
    """The program's outputs of one scan, read back from its files: per
    reference view its depth and confidence maps, its three masks and its
    PLY points (the PLY holds each view's final-mask pixels, in the pair
    file's order, row-major)."""
    points = files.read_ply_points(ply)
    out, at = {}, 0
    for ref, _ in files.read_pairs(os.path.join(tree["root"], "pair.txt")):
        view = {"depth": files.read_pfm(os.path.join(folder, "depth_est", f"{ref:0>8}.pfm")),
                "conf": files.read_pfm(os.path.join(folder, "confidence", f"{ref:0>8}.pfm"))}
        for k in ("photo", "geo", "final"):
            view[k] = files.read_png(os.path.join(folder, "mask", f"{ref:0>8}_{k}.png")) > 127
        n = int(view["final"].sum())
        view["points"] = points[at:at + n]
        at += n
        out[ref] = view
    if at != len(points):
        raise ValueError(f"{ply} holds {len(points)} points, the final masks {at}")
    return out


def reference_maps(model, tree: dict, pool_index: int, setting: dict, device, control: str | None = None) -> dict:
    """Stage A of the reference on one pool scan's image files (under
    ``control``'s rounding): per reference view its depth and confidence."""
    out = {}
    for req in scan_views(tree, pool_index, setting):
        t = {k: torch.as_tensor(req[k]).to(device) for k in ("imgs", "proj_matrices", "depth_values")}
        d, c = model(t["imgs"].float() / 255.0, t["proj_matrices"], t["depth_values"], rounding(control))
        out[req["ref"]] = {"depth": d[0].cpu().numpy(), "conf": c[0].cpu().numpy()}
    return out


def with_stage_b(out: dict, tree: dict, maps: dict, filt: dict, device, control: str | None = None) -> dict:
    """``out`` (stage A's maps by view) with the masks and points of the
    plain stage B run on ``maps``, as ``program_scan`` gives the program's."""
    out = dict(out)
    b = stage_b(tree, {v: m["depth"] for v, m in maps.items()}, {v: m["conf"] for v, m in maps.items()}, filt, device,
                control)
    for v, r in b.items():
        out[v] = {**out[v], **{k: r[k] for k in ("photo", "geo", "final")}}
        out[v]["points"] = r["points"][r["final"].reshape(-1)]
        out[v]["all_points"] = r["points"]
    return out


def reference_scan(model, tree: dict, pool_index: int, setting: dict, filt: dict, device, maps: dict | None = None,
                   control: str | None = None) -> dict:
    """The reference's outputs of one scan, as ``program_scan`` gives the
    program's: stage A from the image files, and stage B on ``maps`` (the
    program's depth and confidence maps by view) or on its own."""
    out = reference_maps(model, tree, pool_index, setting, device, control)
    return with_stage_b(out, tree, maps or out, filt, device, control)


def scan_errors(got: list[dict], want: list[dict], span: float, control: list[dict] | None = None) -> dict:
    """Over the views of the scans: the mean absolute depth error over the
    depth range and the mean absolute confidence error, and with
    ``control`` (stage A's maps of the control, scan by scan) each over the
    control's own (``depth_err_rel``, ``conf_err_rel``); the share of mask
    pixels that differ (photo, geo and final); and the distance, over the
    depth range, between a point of ``got`` and ``want``'s point of the same
    pixel where both final masks hold it, the largest and the mean."""
    def stage_a(maps):
        d = np.concatenate([np.abs(m[v]["depth"].astype(np.float64) - w["depth"]).reshape(-1) / span
                            for m, w_scan in zip(maps, want) for v, w in w_scan.items()])
        c = np.concatenate([np.abs(m[v]["conf"].astype(np.float64) - w["conf"]).reshape(-1)
                            for m, w_scan in zip(maps, want) for v, w in w_scan.items()])
        return float(d.mean()), float(c.mean())

    if not want:
        raise ValueError("no scan to compare")
    mism, m_px, dist, cover = 0, 0, [], []
    for g_scan, w_scan in zip(got, want):
        for v, w in w_scan.items():
            g = g_scan[v]
            for k in ("photo", "geo", "final"):
                mism += int((g[k] != w[k]).sum())
                m_px += g[k].size
            cover.append(float(g["final"].mean()))
            both = (g["final"] & w["final"]).reshape(-1)
            if both.any():
                idx = np.cumsum(g["final"].reshape(-1)) - 1
                gap = np.abs(g["points"][idx[both]].astype(np.float64) - w["all_points"][both]).max(axis=1)
                dist.append(gap / span)
    dist = np.concatenate(dist) if dist else np.zeros(1)
    depth_err, conf_err = stage_a(got)
    out = {"depth_err": depth_err, "conf_err": conf_err, "mask_mismatch": mism / m_px,
           "points_err": float(dist.max()), "points_err_mean": float(dist.mean()),
           "final_coverage": float(np.mean(cover))}
    if control is not None:
        ctl_depth, ctl_conf = stage_a(control)
        out.update(control_depth_err=ctl_depth, control_conf_err=ctl_conf, depth_err_rel=depth_err / ctl_depth,
                   conf_err_rel=conf_err / ctl_conf)
    return out


def depth_span(tree: dict, setting: dict) -> float:
    return setting["numdepth"] * tree["interval"] * setting["interval_scale"]


def check_scans(ctx: Ctx, tree: dict, outdir: str, state: dict, scans: list[dict]) -> dict:
    s, filt, dev = ctx.config["eval"], ctx.config["filter"], ctx.device
    acq = os.path.join(outdir, os.path.basename(tree["testpath"]))
    got, want, control = [], [], []
    with exact(), torch.no_grad():
        model = ref_mvsnet.MVSNet().to(dev).eval()
        model.load_state_dict(state)
        for scan in scans:
            mine = program_scan(tree, os.path.join(acq, scan["name"]),
                                os.path.join(acq, f"mvsnet{int(scan['name'][4:]):0>3}_l3.ply"))
            got.append(mine)
            want.append(reference_scan(model, tree, scan["pool"], s, filt, dev, maps=mine))
            control.append(reference_maps(model, tree, scan["pool"], s, dev, ctx.workload["control"]))
    return scan_errors(got, want, depth_span(tree, s), control)
