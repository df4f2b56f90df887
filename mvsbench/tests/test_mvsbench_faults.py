"""Whole runs of each cell at a small size on the CPU, past the harness's
look for a card: a sound run is correct, and each fault the cell can have,
planted in the program under the timed path, makes ``correct`` false:
a train step that returns its state unchanged, half of the batch left out,
and an answer (a depth map) altered where it is produced. The cells run on
one card, so no exchange between cards can be left out. Each cell's
control (the reference one precision down in the program's place) fails
one of the cell's limits at the same small size."""

import copy
import time

import pytest
import torch

from mvsbench import control, core, manifest, run
from mvsbench.kinds import scan

PORT = "scene_3dreconstruction_mvsnet_tpu_torch"
SMALL = {"train": {"img_hw": [32, 64], "numdepth": 8, "depth_interval": 60.0, "batch": 2, "dtype": "float32"},
         "eval": {"img_hw": [64, 96], "numdepth": 8, "depth_interval": 60.0, "dtype": "float32"}}
CELLS = {"dtu_train": {"pool": 3}, "dtu_request": {"pool": 3, "checked": 2},
         "bin_scan": {"pool": 2, "checked": 1, "checked_among": 2}}


def small_cell(cell: str) -> tuple[dict, dict, dict]:
    """The cell's workload, and its configuration and traffic at a small size."""
    workload = manifest.workload(cell)
    config = copy.deepcopy(manifest.config(workload["config"]))
    for section, values in SMALL.items():
        if section in config:
            config[section].update({k: v for k, v in values.items() if k in config[section] or k == "dtype"})
    if cell == "bin_scan":
        config["eval"]["img_hw"] = [32, 64]
    return workload, config, dict(manifest.traffic(workload["traffic"]), **CELLS[cell])


def small_run(cell: str):
    workload, config, traffic = small_cell(cell)
    outcome, _ = run.execute(workload, 2147483647 + 11, 0.5, False, torch.device("cpu"),
                             {"config": config, "traffic": traffic}, t_start=time.perf_counter())
    return outcome


def correct(outcome) -> bool:
    return all(c.ok for c in outcome.checks) and bool(outcome.checks)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    outcome = small_run(cell)
    assert correct(outcome), [(c.name, c.value, c.limit) for c in outcome.checks]
    assert outcome.attempted > 0 and outcome.failed == 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_a_limit(cell):
    workload, config, traffic = small_cell(cell)
    ctx = core.Ctx(workload=workload, config=config, traffic=traffic, seed=2147483647 + 12, seconds=0.5,
                   trace=False, device=torch.device("cpu"), work_dir=core.work_dir(run.CHECKOUT, workload["name"]),
                   t_start=time.perf_counter())
    readings = control.CONTROLS[traffic["kind"]](ctx, workload["control"])
    numbers = readings["control_" + workload["control"]]
    assert any(numbers[k] > limit for k, limit in workload["limits"].items()), numbers


def _broken_train_step(monkeypatch, fault: str):
    import scene_3dreconstruction_mvsnet_tpu_torch.train as train

    make = train.make_train_step

    def broken(model, optimizer, scheduler, device, *args, **kwargs):
        step = make(model, optimizer, scheduler, device, *args, **kwargs)
        if fault == "altered_answer":
            model.register_forward_hook(lambda m, a, out: {**out, "depth": out["depth"] * 1.05})
            return step

        def faulty(batch):
            if fault == "half_batch":
                return step({k: v[: len(v) // 2] for k, v in batch.items()})
            saved = {k: v.clone() for k, v in model.state_dict().items()}
            aux = step(batch)
            model.load_state_dict(saved)  # the step's update is lost
            optimizer.state.clear()
            return aux

        return faulty

    monkeypatch.setattr(train, "make_train_step", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_answer"])
def test_train_faults_are_not_correct(monkeypatch, fault):
    _broken_train_step(monkeypatch, fault)
    assert not correct(small_run("dtu_train"))


def test_an_altered_request_answer_is_not_correct(monkeypatch):
    import scene_3dreconstruction_mvsnet_tpu_torch.infer as infer_module

    make = infer_module.make_infer_step

    def altered(model, device):
        infer = make(model, device)
        return lambda *args: {**(out := infer(*args)), "depth": out["depth"] * 1.05}

    monkeypatch.setattr(infer_module, "make_infer_step", altered)
    assert not correct(small_run("dtu_request"))


def test_an_altered_scan_answer_is_not_correct(monkeypatch):
    monkeypatch.setattr(scan, "CHILD_MODULE", "mvsbench.tests.faulty_serve")
    assert not correct(small_run("bin_scan"))
