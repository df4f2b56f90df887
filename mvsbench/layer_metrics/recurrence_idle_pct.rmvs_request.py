"""The device's idle share of R-MVSNet's recurrence: the window's idle
seconds that fall in the port's ``rmvsnet.recurrence`` span (``spans.join``'s
``idle_by_span``, with those of the ``rmvsnet.sweep`` spans inside it, which
take the gaps there as the innermost span) over the span's host wall summed
over the window. The host's launches a plane against the device's work a
plane: what a launch-overhead change (CUDA graphs, a fused GRU step) starts
from."""


def read(record):
    trace = record.get("trace") or {}
    idle, span = trace.get("idle_by_span"), trace.get("program_spans", {}).get("rmvsnet.recurrence")
    if idle is None or not span:
        return None
    seconds = idle.get("rmvsnet.recurrence", 0.0) + idle.get("rmvsnet.sweep", 0.0)
    return 100.0 * seconds / (span["ms"] * span["n"] / 1e3)
