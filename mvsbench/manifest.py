"""The benchmark's files, found by name.

``BENCHMARK.json`` (the checkout's root) lists the cells and the metrics.
Each item has a file of its own under ``mvsbench/``:

- a cell: ``workloads/<cell>.json`` (its configuration, traffic, chips, why
  and the limits of its correctness checks);
- a configuration: ``configs/<config>.json``;
- a traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the code
  that drives it, ``kinds/<kind>.py``;
- a per-layer metric: ``layer_metrics/<metric>.py``, whose ``read(record)``
  returns the metric from what the run recorded, or None.

A new cell, configuration, traffic mix, kind or metric is a new file; no
file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(checkout: str = CHECKOUT) -> dict:
    return _json(os.path.join(checkout, "BENCHMARK.json"))


def workload(name: str, root: str = HERE) -> dict:
    return {"name": name, **_json(os.path.join(root, "workloads", f"{name}.json"))}


def config(name: str, root: str = HERE) -> dict:
    return {"name": name, **_json(os.path.join(root, "configs", f"{name}.json"))}


def traffic(name: str, root: str = HERE) -> dict:
    return {"name": name, **_json(os.path.join(root, "traffic", f"{name}.json"))}


def kind(name: str):
    """The module that drives traffic of kind ``name`` (``kinds/<name>.py``)."""
    return importlib.import_module(f"mvsbench.kinds.{name}")


def reader(metric: str, root: str = HERE):
    """``read`` of ``layer_metrics/<metric>.py``."""
    path = os.path.join(root, "layer_metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"mvsbench.layer_metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and the per-layer metrics that ``cell`` reports: those
    whose ``workloads`` name it; without that key, every end-to-end metric,
    and every per-layer metric whose ``moves`` the cell reports."""
    def mine(metric):
        return cell in metric["workloads"] if "workloads" in metric else None

    e2e = [m for m in bench["end_to_end"] if mine(m) is not False]
    names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"] if mine(m) or (mine(m) is None and m["moves"] in names)]
    return e2e, layers
