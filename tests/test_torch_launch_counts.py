"""The kernels' launch registry (``ops/kernels/__init__.py``) on the CPU:
``launch`` with the device guard and the current stream replaced by fakes
and a Python callable standing in for a library's C entry point. Each
launch counts under its own name only, a name outside ``KERNEL_NAMES`` is
refused, a failed launch raises the library's message and counts nothing,
no wrapper keeps launch code of its own, and child processes log their
counts at exit (``MVSNET_TORCH_LAUNCH_LOG``)."""

import ast
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parents[1]
KERNELS_DIR = REPO / "scene_3dreconstruction_mvsnet_tpu_torch" / "ops" / "kernels"

# the fakes of the device guard and of the current stream, and a C entry
# point, as source that a child process runs too
FAKES = """
import contextlib
from types import SimpleNamespace

import torch

STREAM = 0x5EED  # the fake current stream's handle
GUARDED = []  # the devices whose guard is held


@contextlib.contextmanager
def fake_device(device):
    GUARDED.append(device)
    try:
        yield
    finally:
        GUARDED.remove(device)


torch.cuda.device = fake_device
torch.cuda.current_stream = lambda device=None: SimpleNamespace(cuda_stream=STREAM)


def entry(returns=0, calls=None):
    \"\"\"A C entry point: records its arguments and the guards held, returns
    ``returns``; its library decodes a code n as "fake error n".\"\"\"
    def fn(*args):
        if calls is not None:
            calls.append((args, list(GUARDED)))
        return returns
    fn.library = SimpleNamespace(name="fake", error_string=lambda err: f"fake error {err}".encode())
    return fn
"""


def install_fakes(monkeypatch) -> SimpleNamespace:
    """The fakes' namespace, with torch.cuda's guard and stream patched until
    ``monkeypatch`` undoes them; the registry reset to 0."""
    ns = {}
    # monkeypatch keeps the originals to put back after the test; the fakes' source replaces them
    monkeypatch.setattr(torch.cuda, "device", torch.cuda.device)
    monkeypatch.setattr(torch.cuda, "current_stream", torch.cuda.current_stream)
    exec(FAKES, ns)
    kernels.reset_launch_counts()
    return SimpleNamespace(**ns)


@pytest.fixture
def fakes(monkeypatch):
    yield install_fakes(monkeypatch)
    kernels.reset_launch_counts()


@pytest.mark.parametrize("name", kernels.KERNEL_NAMES)
def test_a_launch_counts_under_its_own_name_only(fakes, name):
    """One launch passes its arguments and then the stream, under the
    device's guard, moves its name by its launch count and no other name;
    a reset zeroes it."""
    calls, device = [], torch.device("cuda:0")
    launches = 3 if name in ("batch_norm_train", "batch_norm_backward", "prob_conv_backward") else 1
    kernels.launch(fakes.entry(calls=calls), 7, None, 2.5, device=device, name=name, launches=launches)
    assert calls == [((7, None, 2.5, fakes.STREAM), [device])] and fakes.GUARDED == []
    assert kernels.launch_counts() == dict(dict.fromkeys(kernels.KERNEL_NAMES, 0), **{name: launches})
    kernels.launch(fakes.entry(), device=device, name=name)
    assert kernels.launch_counts()[name] == launches + 1
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_NAMES, 0)


def test_a_name_outside_the_kernel_names_is_refused(fakes):
    """An unknown name is refused before the entry point is called."""
    calls = []
    for name in ("sweep_variance_bf16", "batch_norm", ""):
        with pytest.raises(ValueError, match="not one of the kernel names"):
            kernels.launch(fakes.entry(calls=calls), device=torch.device("cuda:0"), name=name)
    assert calls == [] and not any(kernels.launch_counts().values())


def test_a_failed_launch_raises_the_library_message_and_counts_nothing(fakes):
    """A nonzero return raises RuntimeError with the library's name and its
    error string for that code; the guard is released and nothing counts."""
    with pytest.raises(RuntimeError, match="fake kernel launch failed: fake error 9"):
        kernels.launch(fakes.entry(returns=9), 1, 2, device=torch.device("cuda:0"), name="warp_grad")
    assert fakes.GUARDED == [] and not any(kernels.launch_counts().values())


def test_launch_counts_is_a_copy_of_the_registry(fakes):
    """launch_counts hands out a copy: editing it moves nothing."""
    counts = kernels.launch_counts()
    counts["conv0_fused"] = 5
    assert kernels.launch_counts()["conv0_fused"] == 0 and list(counts) == list(kernels.KERNEL_NAMES)


def test_no_wrapper_keeps_its_own_launch_code():
    """No wrapper module holds a launch-count global, reads the current
    stream, takes the device guard or decodes an error code itself: each
    launches through ``kernels.launch``."""
    wrappers = sorted(p for p in KERNELS_DIR.glob("*.py") if p.name != "__init__.py")
    assert len(wrappers) == 8
    for path in wrappers:
        source = path.read_text()
        tree = ast.parse(source)
        globals_ = {t.id for node in tree.body if isinstance(node, (ast.Assign, ast.AnnAssign))
                    for t in (node.targets if isinstance(node, ast.Assign) else [node.target])
                    if isinstance(t, ast.Name)}
        assert not {g for g in globals_ if "LAUNCHES" in g}, path.name
        assert not any(isinstance(node, ast.Global) for node in ast.walk(tree)), path.name
        for text in ("cuda_stream", "current_stream", "torch.cuda.device(", "error_string"):
            assert text not in source, (path.name, text)
        assert "launch(" in source, path.name


def test_child_processes_log_their_launches(tmp_path):
    """A process started with MVSNET_TORCH_LAUNCH_LOG appends its kernel
    launch counts to that file at exit, and read_launch_log sums the lines:
    how chip_smoke.py sees the kernels the runner's child processes launch."""
    log = tmp_path / "launches.jsonl"
    assert kernels.read_launch_log(log) == dict.fromkeys(kernels.KERNEL_NAMES, 0)
    env = dict(os.environ, **{kernels.LAUNCH_LOG_ENV: str(log)})
    for k1, k2 in ((5, 1), (2, 4)):
        child = FAKES + (
            "from scene_3dreconstruction_mvsnet_tpu_torch.ops import kernels\n"
            f"for name, n in (('sweep_variance', {k1}), ('sweep_variance_emit', 2), ('softmax_regression', {k2})):\n"
            "    for _ in range(n):\n"
            "        kernels.launch(entry(), device=torch.device('cuda:0'), name=name)\n")
        subprocess.run([sys.executable, "-c", child], cwd=REPO, env=env, check=True, timeout=120)
    total = kernels.read_launch_log(log)
    assert total == dict(dict.fromkeys(kernels.KERNEL_NAMES, 0), sweep_variance=7, sweep_variance_emit=4,
                         softmax_regression=5)
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_NAMES, 0)
