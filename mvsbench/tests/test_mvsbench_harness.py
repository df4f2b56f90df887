"""The harness against its contract: the manifest's names and units, the
metrics each cell reports, discovery of new files by name, no run without
a card, and nothing of JAX or the JAX package imported."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from mvsbench import core, manifest, run

CHECKOUT = manifest.CHECKOUT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.benchmark()


def test_benchmark_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32 and all(LINE.match(w) for w in bench["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/") and os.path.isfile(os.path.join(CHECKOUT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and LINE.match(w["why"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in bench["end_to_end"])
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline") or "_roofline_" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(spellings) == 1 for spellings in layers.values())


def test_workload_files_match_the_manifest(bench):
    for w in bench["workloads"]:
        cell = manifest.workload(w["name"])
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == {k: w[k] for k in
                                                                          ("config", "traffic", "chips", "why")}
        assert manifest.config(w["config"])["name"] == w["config"]
        assert manifest.traffic(w["traffic"])["kind"] in ("train", "request", "scan")
        assert cell["limits"] and cell["control"] in ("tf32", "bf16", "fp8")


def test_every_cell_reports_what_its_metrics_move(bench):
    for w in bench["workloads"]:
        e2e, layers = manifest.cell_metrics(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layers
        for m in layers:
            assert m["moves"] in names, (w["name"], m["name"])
    for m in bench["per_layer"]:
        for cell in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in manifest.cell_metrics(bench, cell)[0]}
        assert callable(manifest.reader(m["name"]))


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_new_files_are_found_by_name(tmp_path, bench):
    root = tmp_path / "mvsbench"
    shutil.copytree(manifest.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(root)
    (root / "configs" / "mvsnet_new.json").write_text(json.dumps({"numdepth": 96}))
    (root / "traffic" / "request_pair.json").write_text(json.dumps({"kind": "request", "pool": 2}))
    (root / "workloads" / "new_cell.json").write_text(json.dumps(
        {"config": "mvsnet_new", "traffic": "request_pair", "chips": 1, "why": "a new cell", "control": "fp8",
         "limits": {"depth_err": 1.0}}))
    (root / "layer_metrics" / "new_metric.request.py").write_text(
        "def read(record):\n    return record.get('new')\n")
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [{"name": "new_cell", "config": "mvsnet_new",
                                              "traffic": "request_pair", "chips": 1, "why": "a new cell"}]
    new["per_layer"] = bench["per_layer"] + [{"name": "new_metric.request", "unit": "ms", "better": "lower",
                                              "source": "program_span", "layer": "serving entry",
                                              "moves": "depthmaps_per_s", "workloads": ["new_cell"]}]
    new["end_to_end"] = [dict(m, workloads=m["workloads"] + ["new_cell"]) if m["name"] == "depthmaps_per_s" else m
                         for m in bench["end_to_end"]]
    cell = manifest.workload("new_cell", str(root))
    assert cell["config"] == "mvsnet_new" and manifest.config("mvsnet_new", str(root))["numdepth"] == 96
    assert manifest.traffic("request_pair", str(root))["kind"] == "request"
    assert manifest.reader("new_metric.request", str(root))({"new": 3.5}) == 3.5
    e2e, layers = manifest.cell_metrics(new, "new_cell")
    assert {m["name"] for m in e2e} == {"setup_s", "depthmaps_per_s"}
    assert [m["name"] for m in layers] == ["new_metric.request"]
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before  # no file that was there changed


def _run_harness(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "mvsbench/run.py", "--workload", "dtu_request", "--seed", "2147483999",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = _run_harness(CHECKOUT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "CUDA" in out.stderr


def test_a_directory_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "mvsbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_harness(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0 and '"correct"' not in out.stdout


HARNESS_MODULES = ["mvsbench", "mvsbench.run", "mvsbench.manifest", "mvsbench.core", "mvsbench.scenes",
                   "mvsbench.weights", "mvsbench.timing", "mvsbench.roofline", "mvsbench.readers",
                   "mvsbench.serve_child", "mvsbench.control", "mvsbench.kinds.train", "mvsbench.kinds.request",
                   "mvsbench.kinds.scan", "mvsbench.reference.mvsnet", "mvsbench.reference.fusion",
                   "mvsbench.reference.files", "mvsbench.reference.precision"]


def _loaded_after(imports: str) -> list[str]:
    code = (f"import sys, json\nsys.path.insert(0, {CHECKOUT!r})\n{imports}\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_imports_nothing_of_jax_or_the_jax_package():
    readers = "".join(f"manifest.reader({m['name']!r})\n" for m in manifest.benchmark()["per_layer"])
    loaded = _loaded_after("".join(f"import {m}\n" for m in HARNESS_MODULES) + "from mvsbench import manifest\n"
                           + readers + f"import {core.PORT}.infer, {core.PORT}.eval_cli, {core.PORT}.train\n")
    assert not set(loaded) & set(core.FORBIDDEN), loaded
    assert core.PORT in loaded  # the port itself is allowed: its name is compared whole


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "scene_3dreconstruction_mvsnet_tpu_torch_x", sys)
    assert "scene_3dreconstruction_mvsnet_tpu_torch_x" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "scene_3dreconstruction_mvsnet_tpu.fake", sys)
    assert "scene_3dreconstruction_mvsnet_tpu.fake" in core.forbidden_modules()


def test_the_result_line_puts_the_checks_last(bench):
    outcome = core.Outcome(e2e={"depthmaps_per_s": 20.0, "request_p95_s": 0.05, "setup_s": 9.0}, record={},
                           attempted=10, failed=0,
                           checks=[core.Check("depth_err", 1e-5, 2e-4), core.Check("conf_err", 1.0, 2e-4)],
                           memory_peak_bytes=123)
    line = run.result_line(bench, manifest.workload("dtu_request"), outcome, False,
                           {"platform": "gpu", "kind": "card", "count": 1})
    assert list(line)[-1] == "checks" and line["correct"] is False
    assert set(line["metrics"]) == {"depthmaps_per_s", "request_p95_s", "setup_s"}
    assert line["device"]["memory_peak_bytes"] == 123


@pytest.mark.cuda
def test_each_cell_runs_on_the_card(card):
    for cell in ("dtu_request",):
        out = subprocess.run([sys.executable, "mvsbench/run.py", "--workload", cell, "--seed", "2147483901",
                              "--seconds", "3", "--trace", "1"], cwd=CHECKOUT, capture_output=True, text=True,
                             timeout=1200)
        assert out.returncode == 0, out.stderr[-4000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["busy_s"] > 0 and list(line)[-1] == "checks"
