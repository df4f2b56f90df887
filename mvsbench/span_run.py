"""Run one cell traced, with the port's own spans joined to the device trace.

    python3 mvsbench/span_run.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the machine with the card. This is
``run.py --trace 1`` with two things put in place: the traced window's
``DeviceTrace`` is ``spans.SpanDeviceTrace`` (the port's span tracer on, its
kernel launch counts reset over the window), and the result line gains,
before ``checks``, ``span_metrics`` (each reader of SPAN_METRICS that finds
its span or counter), ``program_spans``, ``idle_by_span`` (with ``idle_s``,
the window minus the device's busy union) and ``launches``. It exits as
``run.py`` does.

The cells' traffic kinds build their ``DeviceTrace`` themselves, and their
files are not changed here, so this entry point puts ``SpanDeviceTrace`` in
the kind's module in its place; ``run.py`` runs them as they are.
"""

from __future__ import annotations

import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

SPAN_METRICS = {  # per-layer metrics read from the port's spans and counters, by the cell's traffic kind
    "request": ["h2d_ms.request", "costreg_span_ms.request", "kernel_launches.request"],
    "train": ["feed_wait_ms.train", "costreg_fwd_span_ms.train", "sweep_bwd_span_ms.train", "kernel_launches.train"],
}


def main(argv: list[str] | None = None) -> int:
    from mvsbench import manifest, run

    args = run.parse(argv)
    run.set_caches()
    argv = ["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace", "1"]
    try:
        kind = manifest.traffic(manifest.workload(args.workload)["traffic"])["kind"]
    except FileNotFoundError:
        return run.main(argv)  # which says what is missing
    if kind not in SPAN_METRICS:
        print(f"mvsbench: no span metrics for traffic of kind {kind}", file=sys.stderr)
        return 2
    from mvsbench import spans

    manifest.kind(kind).DeviceTrace = spans.SpanDeviceTrace
    plain = run.result_line

    def result_line(bench, workload, outcome, trace, device_info):
        line = plain(bench, workload, outcome, trace, device_info)
        checks, record, got = line.pop("checks"), {**outcome.record, "e2e": outcome.e2e}, outcome.trace
        values = {name: manifest.reader(name)(record) for name in SPAN_METRICS[kind]}
        line["span_metrics"] = {name: v for name, v in values.items() if v is not None}
        line["program_spans"], line["launches"] = got["program_spans"], got["launches"]
        line["idle_by_span"] = {**got["idle_by_span"], "idle_s": got["window_s"] - got["busy_s"]}
        line["checks"] = checks
        return line

    run.result_line = result_line
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
