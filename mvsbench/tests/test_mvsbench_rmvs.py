"""The R-MVSNet cell's files: the kind at a tiny size on the CPU, its
readings, its readers, its roofline against the flop counter, its manifest
entries, and the reference's imports."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mvsbench import core, manifest, roofline, roofline_rmvs, run
from mvsbench.reference import rmvsnet as ref_rmvs

CELL = "rmvs_dtu_request"
READERS = ["features_ms.rmvs_request", "recurrence_ms.rmvs_request", "recurrence_idle_pct.rmvs_request",
           "sweep_roofline_pct.rmvs_request", "mfu_pct.request", "device_idle_pct.request"]


def _tiny():
    config = manifest.config("rmvsnet_dtu")
    config["eval"].update({"views": 3, "img_hw": [64, 80], "numdepth": 16, "depth_interval": 25.0,
                           "interval_scale": 1.0, "dtype": "float32"})
    return {"config": config, "traffic": dict(manifest.traffic("rmvs_request_closed"), pool=2, warm=1, checked=2)}


def _ctx(seed=5):
    tiny = _tiny()
    return core.Ctx(workload=manifest.workload(CELL), config=tiny["config"], traffic=tiny["traffic"], seed=seed,
                    seconds=0.5, trace=False, device=torch.device("cpu"),
                    work_dir=core.work_dir(manifest.CHECKOUT, CELL), t_start=time.perf_counter())


def test_the_kind_runs_at_a_tiny_size_on_the_cpu():
    outcome, _ = run.execute(manifest.workload(CELL), 2147483999, 0.5, False, torch.device("cpu"), configs=_tiny(),
                             t_start=time.perf_counter())
    assert set(outcome.e2e) == {"depthmaps_per_s", "request_p95_s", "setup_s"}
    assert outcome.attempted == outcome.record["requests"] >= 1 and outcome.failed == 0
    assert [c.name for c in outcome.checks] == ["depth_err_rel", "conf_err_rel"]
    # f32 on the CPU: the program is the reference's arithmetic in another order
    assert all(c.ok and c.value < 1e-2 for c in outcome.checks)
    assert outcome.record["shapes"] == {"B": 1, "V": 3, "D": 16, "H": 64, "W": 80, "h": 16, "w": 20, "C": 32,
                                        "feat": "f32", "vol": "f32"}
    assert outcome.record["flops_per_depthmap"] == roofline_rmvs.forward_flops(1, 3, 16, 64, 80)
    line = run.result_line(manifest.benchmark(), manifest.workload(CELL), outcome, False,
                           {"platform": "cpu", "kind": "cpu", "count": 1})
    assert set(line["metrics"]) == {"depthmaps_per_s", "request_p95_s", "setup_s"} and line["correct"]


def test_an_altered_answer_is_not_correct(monkeypatch):
    """A fault planted where the answer is produced: every R-MVSNet of the
    port scales its depth by 1.05 in a forward hook, under the timed path."""
    from scene_3dreconstruction_mvsnet_tpu_torch.models import rmvsnet

    init = rmvsnet.RMVSNet.__init__

    def hooked(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.register_forward_hook(lambda module, inputs, out: {**out, "depth": out["depth"] * 1.05})

    monkeypatch.setattr(rmvsnet.RMVSNet, "__init__", hooked)
    outcome, _ = run.execute(manifest.workload(CELL), 2147483999, 0.5, False, torch.device("cpu"), configs=_tiny(),
                             t_start=time.perf_counter())
    assert outcome.attempted >= 1 and outcome.checks and not all(c.ok for c in outcome.checks)


def test_a_port_without_rmvsnet_fails_at_set_up(monkeypatch):
    """The parent of the change that adds R-MVSNet has no "rmvsnet" in its
    registry: the kind raises before it makes a request or a weight."""
    from scene_3dreconstruction_mvsnet_tpu_torch import models

    monkeypatch.delitem(models._MODELS, "rmvsnet")
    with pytest.raises(ImportError, match="no R-MVSNet"):
        run.execute(manifest.workload(CELL), 1, 0.5, False, torch.device("cpu"), configs=_tiny(),
                    t_start=time.perf_counter())


def test_the_readings_give_the_control_the_witness_each_fault_and_the_maps():
    from mvsbench.kinds import rmvs_request

    out = rmvs_request.readings(_ctx())
    assert set(out) == {"control_fp8", "bf16_rounding", "maps", *("fault_" + f for f in ref_rmvs.FAULTS)}
    assert out["control_fp8"]["depth_err_rel"] == 1.0
    assert out["fault_no_recurrence"]["depth_err_rel"] > out["bf16_rounding"]["depth_err_rel"]
    maps = out["maps"]
    assert maps["planes_used"] >= 4 and maps["no_recurrence_moved"] > 0.1 and maps["prob_over_uniform"] > 1.0


SPANS = {"rmvsnet.features": [4.0, 6.0], "rmvsnet.recurrence": [200.0, 220.0], "rmvsnet.sweep": [0.5] * 16,
         "rmvsnet.regress": [0.1, 0.1]}
SHAPES = {"B": 1, "V": 5, "D": 256, "H": 1200, "W": 1600, "h": 300, "w": 400, "C": 32, "feat": "bf16", "vol": "bf16"}
RECORD = {"requests": 2, "depthmaps": 2, "window_s": 1.0, "flops_per_depthmap": 1e12, "shapes": SHAPES,
          "trace": {"busy_s": 0.4, "window_s": 1.0, "span_device_ms": SPANS,
                    "idle_by_span": {"rmvsnet.recurrence": 0.3, "rmvsnet.sweep": 0.02, "infer": 0.1},
                    "program_spans": {"rmvsnet.recurrence": {"n": 2, "ms": 400.0, "self_ms": 390.0}}}}
EXPECTED = {
    "features_ms.rmvs_request": 5.0, "recurrence_ms.rmvs_request": 210.0,
    "recurrence_idle_pct.rmvs_request": 100.0 * 0.32 / 0.8,
    "sweep_roofline_pct.rmvs_request": 100.0 * roofline.sweep_bound_s(1, 5, 256, 300, 400, 32, "bf16", "bf16") / 4e-3,
    "mfu_pct.request": 100.0 * 2e12 / 1.0 / roofline.PEAK_FLOPS["bf16"], "device_idle_pct.request": 60.0}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_a_number_or_none(name):
    read = manifest.reader(name)
    assert read(RECORD) == pytest.approx(EXPECTED[name], rel=1e-12)
    assert read({}) is None and read({"requests": 2, "trace": None}) is None


def test_the_manifest_names_the_cell_and_its_metrics():
    bench = manifest.benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "rmvsnet_dtu" and len(cell["why"]) <= 200
    assert cell["why"] == manifest.workload(CELL)["why"]
    e2e, layers = manifest.cell_metrics(bench, CELL)
    assert {m["name"] for m in e2e} == {"setup_s", "depthmaps_per_s", "request_p95_s"}
    assert sorted(m["name"] for m in layers) == sorted(READERS)
    config = manifest.config("rmvsnet_dtu")
    assert (config["feature_channels"], config["gru_channels"], config["numdepth"]) == (32, [16, 4, 2], 256)
    ev = config["eval"]
    assert (ev["views"], ev["img_hw"], ev["batch"], ev["dtype"]) == (5, [1200, 1600], 1, "bfloat16")
    assert ev["depth_interval"] * ev["interval_scale"] == 2.0 and ev["depth_min"] == 425.0
    assert config["reduced"] == ["eval", "refinement"]
    assert next(c for c in bench["configs"] if c["name"] == "rmvsnet_dtu")["reduced"] == config["reduced"]
    limits = manifest.workload(CELL)["limits"]
    assert set(limits) == {"depth_err_rel", "conf_err_rel"} and all(0 < v < 1 for v in limits.values())


def test_the_rmvsnet_flops_match_the_flop_counter():
    model = ref_rmvs.RMVSNet().eval()
    B, V, H, W, D = 1, 3, 32, 48, 6
    proj = torch.eye(4).expand(B, V, 4, 4).clone()
    proj[:, :, 0, 3] = torch.arange(V, dtype=torch.float32)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.rand(B, V, H, W, 3), proj, torch.linspace(400.0, 900.0, D)[None])
    counts = counter.get_flop_counts()["Global"]
    convs = sum(n for op, n in counts.items() if "convolution" in str(op))
    assert convs == 2 * roofline.feature_macs(B * V, H, W) + roofline_rmvs.recurrence_flops(B, D, H // 4, W // 4)
    # the recurrence is ~93 % of the model FLOPs at the DTU test setting (1.29 of 1.43 TFLOP)
    full = roofline_rmvs.forward_flops(1, 5, 256, 1200, 1600)
    assert roofline_rmvs.recurrence_flops(1, 256, 300, 400) == pytest.approx(1.286e12, rel=1e-3)
    assert roofline_rmvs.recurrence_flops(1, 256, 300, 400) / full == pytest.approx(0.902, abs=0.01)


def test_the_reference_imports_nothing_of_the_port_or_of_jax():
    code = ("import sys, json\nsys.path.insert(0, {!r})\nimport mvsbench.reference.rmvsnet\n"
            "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))").format(manifest.CHECKOUT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {core.PORT, *core.FORBIDDEN}, loaded


def test_the_control_script_needs_a_card():
    out = subprocess.run([sys.executable, "mvsbench/rmvs_control.py", "--control-seeds", "1"],
                         cwd=manifest.CHECKOUT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode == 3 and "CUDA" in out.stderr
