"""The cascade cell's files: the kind at a tiny size on the CPU, its readers,
its roofline against the flop counter, its manifest entries, and the
reference's imports."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mvsbench import core, manifest, roofline, roofline_cascade, run
from mvsbench.reference import casmvsnet as ref_cas

CELL = "casmvs_dtu_request"
READERS = ["fpn_ms.cascade_request", "costreg_ms.cascade_request", "stage3_ms.cascade_request",
           "sweep_roofline_pct.cascade_request", "regression_roofline_pct.cascade_request",
           "mfu_pct.cascade_request", "device_idle_pct.cascade_request", "kernel_launches.cascade_request"]


def _tiny():
    config = manifest.config("casmvsnet_dtu")
    config["ndepths"] = [16, 8, 8]
    config["eval"].update({"views": 3, "img_hw": [64, 96], "dtype": "float32"})
    return {"config": config, "traffic": dict(manifest.traffic("cascade_request_closed"), pool=2, warm=1, checked=2)}


def test_the_kind_runs_at_a_tiny_size_on_the_cpu():
    outcome, ctx = run.execute(manifest.workload(CELL), 2147483999, 0.5, False, torch.device("cpu"), configs=_tiny(),
                               t_start=time.perf_counter())
    assert set(outcome.e2e) == {"depthmaps_per_s", "request_p95_s", "setup_s"}
    assert outcome.attempted == outcome.record["requests"] >= 1 and outcome.failed == 0
    assert [c.name for c in outcome.checks] == ["depth_err_rel", "conf_err_rel"]
    # f32 on the CPU: the program is the reference's arithmetic in another order
    assert all(c.ok and c.value < 1e-2 for c in outcome.checks)
    assert outcome.record["stages"] == [{"D": 16, "h": 16, "w": 24, "C": 32}, {"D": 8, "h": 32, "w": 48, "C": 16},
                                        {"D": 8, "h": 64, "w": 96, "C": 8}]
    line = run.result_line(manifest.benchmark(), manifest.workload(CELL), outcome, False,
                           {"platform": "cpu", "kind": "cpu", "count": 1})
    assert set(line["metrics"]) == {"depthmaps_per_s", "request_p95_s", "setup_s"} and line["correct"]


def test_an_altered_cascade_answer_is_not_correct(monkeypatch):
    """A fault planted where the answer is produced: every CasMVSNet of the
    port scales its depth by 1.05 in a forward hook, under the timed path."""
    from scene_3dreconstruction_mvsnet_tpu_torch.models import cas_mvsnet

    init = cas_mvsnet.CasMVSNet.__init__

    def hooked(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.register_forward_hook(lambda module, inputs, out: {**out, "depth": out["depth"] * 1.05})

    monkeypatch.setattr(cas_mvsnet.CasMVSNet, "__init__", hooked)
    outcome, _ = run.execute(manifest.workload(CELL), 2147483999, 0.5, False, torch.device("cpu"), configs=_tiny(),
                             t_start=time.perf_counter())
    assert outcome.attempted >= 1 and outcome.failed == 0 and outcome.checks
    assert not all(c.ok for c in outcome.checks), [(c.name, c.value, c.limit) for c in outcome.checks]
    line = run.result_line(manifest.benchmark(), manifest.workload(CELL), outcome, False,
                           {"platform": "cpu", "kind": "cpu", "count": 1})
    assert line["correct"] is False


def test_the_readings_give_the_control_the_witness_and_each_fault():
    from mvsbench.kinds import cascade_request

    tiny = _tiny()
    ctx = core.Ctx(workload=manifest.workload(CELL), config=tiny["config"], traffic=tiny["traffic"], seed=5,
                   seconds=0.5, trace=False, device=torch.device("cpu"), work_dir=core.work_dir(manifest.CHECKOUT, CELL),
                   t_start=time.perf_counter())
    out = cascade_request.readings(ctx)
    assert set(out) == {"control_fp8", "bf16_rounding", *("fault_" + f for f in ref_cas.FAULTS)}
    assert out["control_fp8"]["depth_err_rel"] == 1.0
    assert out["fault_uniform_planes"]["depth_err_rel"] > 1.0 > out["bf16_rounding"]["depth_err_rel"]


SPANS = {"casmvsnet.fpn": [4.0, 6.0], "casmvsnet.stage3": [20.0, 22.0],
         **{f"casmvsnet.costreg{s}": [10.0 * s, 10.0 * s] for s in (1, 2, 3)},
         **{f"casmvsnet.sweep{s}": [1.0, 1.0] for s in (1, 2, 3)},
         **{f"casmvsnet.regress{s}": [0.1, 0.1] for s in (1, 2, 3)}}
STAGES = roofline_cascade.stages(864, 1152, (48, 32, 8))
RECORD = {"requests": 4, "depthmaps": 4, "window_s": 2.0, "flops_per_depthmap": 1e12, "stages": STAGES,
          "shapes": {"B": 1, "V": 5, "H": 864, "W": 1152, "feat": "bf16", "vol": "bf16", "logits": "bf16"},
          "trace": {"busy_s": 1.5, "window_s": 2.0, "span_device_ms": SPANS,
                    "launches": {"sweep_variance": 4, "sweep_variance_per_pixel": 8, "softmax_regression": 4,
                                 "softmax_regression_per_pixel": 8}}}
EXPECTED = {
    "fpn_ms.cascade_request": 5.0, "costreg_ms.cascade_request": 60.0, "stage3_ms.cascade_request": 21.0,
    "sweep_roofline_pct.cascade_request": 100.0 * roofline_cascade.per_pixel_sweep_bound_s(
        1, 5, STAGES[1:], "bf16", "bf16") / 2e-3,
    "regression_roofline_pct.cascade_request": 100.0 * roofline_cascade.per_pixel_regression_bound_s(
        1, STAGES[1:], "bf16") / 2e-4,
    "mfu_pct.cascade_request": 100.0 * 4e12 / 2.0 / roofline.PEAK_FLOPS["bf16"],
    "device_idle_pct.cascade_request": 25.0, "kernel_launches.cascade_request": 6.0}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_a_number_or_none(name):
    read = manifest.reader(name)
    assert read(RECORD) == pytest.approx(EXPECTED[name], rel=1e-12)
    assert read({}) is None and read({"requests": 4, "trace": None}) is None


def test_the_manifest_names_the_cell_and_its_metrics():
    bench = manifest.benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "casmvsnet_dtu" and len(cell["why"]) <= 200
    e2e, layers = manifest.cell_metrics(bench, CELL)
    assert {m["name"] for m in e2e} == {"setup_s", "depthmaps_per_s", "request_p95_s"}
    assert sorted(m["name"] for m in layers) == sorted(READERS)
    assert all(m["workloads"] == [CELL] for m in layers)
    config = manifest.config("casmvsnet_dtu")
    assert (config["ndepths"], config["depth_inter_r"], config["feature_channels"]) == ([48, 32, 8], [4, 2, 1],
                                                                                       [32, 16, 8])
    limits = manifest.workload(CELL)["limits"]
    assert set(limits) == {"depth_err_rel", "conf_err_rel"} and all(0 < v < 1 for v in limits.values())


def test_the_cascade_flops_match_the_flop_counter():
    model = ref_cas.CasMVSNet(ndepths=(16, 8, 8)).eval()
    B, V, H, W = 1, 3, 64, 96
    proj = torch.eye(4).expand(B, V, 4, 4).clone()
    proj[:, :, 0, 3] = torch.arange(V, dtype=torch.float32)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.rand(B, V, H, W, 3), proj, torch.linspace(400.0, 900.0, 32)[None])
    counts = counter.get_flop_counts()["Global"]
    convs = sum(n for op, n in counts.items() if "convolution" in str(op))
    stages = roofline_cascade.stages(H, W, (16, 8, 8))
    want = 2 * (roofline_cascade.fpn_macs(B * V, H, W)
                + sum(roofline_cascade.costreg_macs(B, s["D"], s["h"], s["w"], s["C"]) for s in stages))
    assert convs == want
    assert roofline_cascade.fpn_macs(5, 864, 1152) == pytest.approx(42.8e9, rel=1e-3)
    full = roofline_cascade.stages(864, 1152, (48, 32, 8))
    assert sum(roofline_cascade.costreg_macs(1, s["D"], s["h"], s["w"], s["C"]) for s in full) == pytest.approx(
        123.2e9, rel=1e-3)


def test_the_per_pixel_bounds_count_the_planes_once():
    st = {"D": 8, "h": 864, "w": 1152, "C": 8}
    points = 8 * 864 * 1152
    assert roofline_cascade.per_pixel_sweep_bytes(1, 5, st, "bf16", "bf16") == \
        5 * 864 * 1152 * 8 * 2 + points * 8 * 2 + points * 4
    assert roofline_cascade.per_pixel_regression_bytes(1, st, "bf16") == points * 2 + points * 4 + 2 * 864 * 1152 * 4
    assert roofline_cascade.per_pixel_regression_bytes(1, st, "bf16") == \
        roofline.regression_bytes(1, 8, 864, 1152, "bf16") + points * 4 - 8 * 4


def test_the_reference_imports_nothing_of_the_port_or_of_jax():
    code = ("import sys, json\nsys.path.insert(0, {!r})\nimport mvsbench.reference.casmvsnet\n"
            "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))").format(manifest.CHECKOUT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {core.PORT, *core.FORBIDDEN}, loaded


def test_the_control_script_needs_a_card():
    out = subprocess.run([sys.executable, "mvsbench/cascade_control.py", "--control-seeds", "1"],
                         cwd=manifest.CHECKOUT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode == 3 and "CUDA" in out.stderr
