"""Small host-side helpers. Counterpart of
``scene_3dreconstruction_mvsnet_tpu/utils/misc.py``: the debug-bitmask
decoder, the argument table the CLIs print, recursive mappers over nested
dicts/lists/tuples of tensors, and the running mean of the scalar dicts."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def get_powers(n: int) -> list[str]:
    """The set bit positions of a debug bitmask, as strings: get_powers(6)
    == ["1", "2"] (the reference's ``--debug_*`` flags)."""
    return [str(p) for p, v in enumerate(bin(n)[:1:-1]) if int(v)]


def print_args(args: Any) -> None:
    """Print an argparse namespace (or a mapping) as a table: one row per
    argument with its value and type."""
    print("#" * 32 + "  args  " + "#" * 32)
    items = vars(args).items() if hasattr(args, "__dict__") else dict(args).items()
    for k, v in items:
        print("{0: <18}\t{1: <30}\t{2: <20}".format(k, str(v), str(type(v))))
    print("#" * 72)


def make_recursive_func(func: Callable) -> Callable:
    """Lift a leaf function to act recursively on nested dict/list/tuple."""

    def wrapper(vars):
        if isinstance(vars, list):
            return [wrapper(x) for x in vars]
        if isinstance(vars, tuple):
            return tuple(wrapper(x) for x in vars)
        if isinstance(vars, dict):
            return {k: wrapper(v) for k, v in vars.items()}
        return func(vars)

    return wrapper


@make_recursive_func
def to_numpy(x):
    """Tensor (on any device) or scalar -> host numpy (recursive); numpy
    arrays, strings, bytes, Python numbers and None pass through."""
    if isinstance(x, np.ndarray) or isinstance(x, (str, bytes, float, int)) or x is None:
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@make_recursive_func
def to_float(x):
    """Scalar tensor or array -> Python float (recursive)."""
    if isinstance(x, float):
        return x
    if isinstance(x, torch.Tensor):
        return float(x.detach().cpu())
    return float(np.asarray(x))


class DictAverageMeter:
    """Running mean of a dict of float scalars (the reference's
    ``utils.py:105-124``)."""

    def __init__(self) -> None:
        self.data: dict[str, float] = {}
        self.count = 0

    def update(self, new_input: dict[str, float]) -> None:
        self.count += 1
        for k, v in new_input.items():
            if not isinstance(v, float):
                raise TypeError(f"DictAverageMeter expects float values, got {k}: {type(v)}")
            self.data[k] = self.data.get(k, 0.0) + v

    def mean(self) -> dict[str, float]:
        return {k: v / self.count for k, v in self.data.items()}
