"""The run recipes: the presets of ``configs/workloads.json`` and the
``scripts/*.sh`` that run them, on the port.

    python -m scene_3dreconstruction_mvsnet_tpu_torch.recipes <preset> [flags...]

calls the preset's CLI (``train_cli`` or ``eval_cli``) with the preset's
flags, then the flags of the script that runs it (its paths), then the
caller's flags, so the caller's win, as ``"$@"`` does in the scripts. Where
a script exists its paths come from the same environment variables with the
same defaults (``DTU_TRAINING``, ``BDS8_TRAINING``, ``DTU_TESTING``,
``CKPT``, which is required, ``LOGDIR``, ``OUTDIR``), and the output goes
both to the terminal and to the same ``train.log`` or ``eval.log`` in the
log or out directory. ``eval_DTU.sh`` also passes ``--dtype=bfloat16``,
which is not part of the preset: add it to run that variant,

    CKPT=model.ckpt python -m scene_3dreconstruction_mvsnet_tpu_torch.recipes eval_DTU --dtype bfloat16

The scripts' TPU flags are not carried over, because the CLIs refuse them
(``train_cli.REFUSED``, ``eval_cli.REFUSED``): ``--pallas_sweep``,
``--pallas_grad`` and ``--use_pallas`` switch TPU kernels, and on the card
K1, K2 and the training sweep's K3-terms and K3 always run;
``--flat_features`` and ``--flat_costreg`` select the flat block-Toeplitz
layouts, which exist for the TPU's tiles and are not ported.

The CLIs run on the card unless ``--device cpu`` is among the flags.
"""

from __future__ import annotations

import importlib
import os
import sys
import traceback
from typing import NamedTuple

# configs/workloads.json's presets, with each CLI's counterpart in the port
PRESETS = {
    "train_DTU": {
        "cli": "train_cli",
        "args": {
            "mode": "train", "dataset": "dtu_yao",
            "trainlist": "lists/dtu/train.txt", "testlist": "lists/dtu/val.txt",
            "epochs": 18, "lr": 0.001,
            "lrepochs": "2,3,4,5,6,7,8,9,10,11,12,13,14,15:1.2",
            "batch_size": 4, "numdepth": 192, "interval_scale": 1.06,
            "NtrainViews": 3, "NtestViews": 5, "dtype": "bfloat16",
        },
    },
    "train_BlenderDS": {
        "cli": "train_cli",
        "args": {
            "mode": "train", "dataset": "blender",
            "trainlist": "lists/BDS8/train200.txt", "testlist": "lists/BDS8/val200.txt",
            "epochs": 16, "lr": 5e-06, "lrepochs": "10,12,14:2",
            "batch_size": 3, "numdepth": 192, "interval_scale": 1.33,
            "Nlights": "3:7", "NtrainViews": 5, "NtestViews": 5, "dtype": "bfloat16",
        },
    },
    "eval_DTU": {
        "cli": "eval_cli",
        "args": {
            "dataset": "dataloader_eval", "dataset_name": "dtu",
            "testlist": "lists/dtu/test.txt",
            "numdepth": 192, "interval_scale": 1.06,
            "NviewGen": 5, "NviewFilter": 10,
            "photomask": 0.75, "geomask": 3,
            "condmask_pixel": 1.0, "condmask_depth": 0.0025, "save_ply": True,
        },
    },
    "eval_BlenderDS": {
        "cli": "eval_cli",
        "args": {
            "dataset": "dataloader_eval", "dataset_name": "bds8",
            "testlist": "lists/BDS8/eval.txt",
            "pairfile": "eval_pair_4x4_30-34-46-47.txt",
            "numdepth": 192, "interval_scale": 1.33,
            "NviewGen": 4, "NviewFilter": 3,
            "photomask": 0.5, "geomask": 2,
            "condmask_pixel": 1.0, "condmask_depth": 0.01, "save_ply": True,
        },
    },
    "eval_binpicking": {
        "cli": "eval_cli",
        "args": {
            "dataset": "dataloader_eval", "dataset_name": "bin",
            "testlist": "lists/Bin/eval.txt",
            "numdepth": 192, "interval_scale": 1.06,
            "NviewGen": 4, "NviewFilter": 3,
            "photomask": 0.1, "geomask": 2,
            "condmask_pixel": 1.0, "condmask_depth": 0.01, "save_ply": True,
        },
    },
}


class Script(NamedTuple):
    """A shell script that runs a preset: its path in the repository, its
    path flags as (flag, environment variable, default; None where the
    variable is required), and the flag whose directory receives its log,
    with the log's name."""

    path: str
    paths: tuple[tuple[str, str, str | None], ...]
    log: tuple[str, str]


SCRIPTS = {
    "train_DTU": Script("scripts/train_DTU.sh",
                        (("--trainpath", "DTU_TRAINING", "./data/dtu_training"),
                         ("--logdir", "LOGDIR", "./outputs/dtu_training")), ("--logdir", "train.log")),
    "train_BlenderDS": Script("scripts/train_BDS8.sh",
                              (("--trainpath", "BDS8_TRAINING", "./data/BDS8"),
                               ("--logdir", "LOGDIR", "./outputs/bds8_training")), ("--logdir", "train.log")),
    "eval_DTU": Script("scripts/eval_DTU.sh",
                       (("--testpath", "DTU_TESTING", "./data/dtu_testing"), ("--loadckpt", "CKPT", None),
                        ("--outdir", "OUTDIR", "./outputs/dtu_eval")), ("--outdir", "eval.log")),
}


def preset_argv(name: str) -> list[str]:
    """The preset's flags as its CLI takes them: ``--key=value``, and
    ``--key`` for a flag that is on."""
    argv = []
    for key, value in PRESETS[name]["args"].items():
        if value is True:
            argv.append(f"--{key}")
        else:
            argv.append(f"--{key}={value}")
    return argv


def script_argv(name: str) -> tuple[list[str], str | None]:
    """The path flags that the preset's script adds, from the environment,
    and the path of its log (None for a preset no script runs)."""
    script = SCRIPTS.get(name)
    if script is None:
        return [], None
    argv, values = [], {}
    for flag, var, default in script.paths:
        value = os.environ.get(var) or default
        if value is None:
            raise SystemExit(f"recipes {name}: set {var} (as {script.path} requires): {flag} takes its value")
        argv.append(f"{flag}={value}")
        values[flag] = value
    log_flag, log_name = script.log
    return argv, os.path.join(values[log_flag], log_name)


class _Tee:
    """A text stream that writes to ``stream`` and to ``log``."""

    def __init__(self, stream, log) -> None:
        self.stream, self.log = stream, log

    def write(self, text: str) -> int:
        self.stream.write(text)
        self.log.write(text)
        return len(text)

    def flush(self) -> None:
        self.stream.flush()
        self.log.flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)


def main(argv: list[str] | None = None):
    """Run ``argv[0]``'s preset with the flags after it; returns what its
    CLI's ``main`` returns."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in PRESETS:
        raise SystemExit("usage: python -m scene_3dreconstruction_mvsnet_tpu_torch.recipes <preset> [flags...]\n"
                         f"presets: {', '.join(PRESETS)}")
    name = argv[0]
    paths, log_path = script_argv(name)
    cli = importlib.import_module(f"{__package__}.{PRESETS[name]['cli']}")
    full = preset_argv(name) + paths + argv[1:]
    if log_path is None:
        return cli.main(full)
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "w") as log:
        streams = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = _Tee(sys.stdout, log), _Tee(sys.stderr, log)
        try:
            return cli.main(full)
        except Exception:
            log.write(traceback.format_exc())
            raise
        finally:
            sys.stdout, sys.stderr = streams


if __name__ == "__main__":
    main()
