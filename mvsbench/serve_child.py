"""The port's eval CLI serve loop, run for the scan traffic.

    python3 -m mvsbench.serve_child <eval_cli arguments>

runs ``scene_3dreconstruction_mvsnet_tpu_torch.eval_cli.main`` unchanged in
this process, with its stdin passed through a filter that takes the
benchmark's own lines out before the serve loop reads them:

  ``#mvsbench trace start <raw>``   start ``torch.profiler`` (CUDA activity),
                                    its trace to be exported to <raw>;
  ``#mvsbench trace stop <out>``    stop it and write the reduced trace to <out> (JSON).

Each is acknowledged on stdout with a ``MVSBENCH`` line. At exit the process
prints its peak device memory and the JAX modules it loaded, if any.
"""

from __future__ import annotations

import json
import sys

import torch

from .core import forbidden_modules
from .timing import DeviceTrace


class Lines:
    """The serve loop's stdin without the benchmark's lines."""

    def __init__(self, stream):
        self.stream = stream
        self.tracer: DeviceTrace | None = None

    def __iter__(self):
        for line in self.stream:
            if not line.startswith("#mvsbench "):
                yield line
                continue
            words = line.split()
            if words[1:3] == ["trace", "start"]:
                self.tracer = DeviceTrace(words[3])
                self.tracer.start()
                print("MVSBENCH trace started", flush=True)
            elif words[1:3] == ["trace", "stop"]:
                with open(words[3], "w") as f:
                    json.dump(self.tracer.stop(), f)
                print("MVSBENCH trace written", flush=True)


def main(argv: list[str]) -> None:
    from scene_3dreconstruction_mvsnet_tpu_torch import eval_cli

    sys.stdin = Lines(sys.stdin)
    try:
        eval_cli.main(argv)
    finally:
        peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
        print(f"MVSBENCH peak {peak}", flush=True)
        print("MVSBENCH modules " + json.dumps(forbidden_modules()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
