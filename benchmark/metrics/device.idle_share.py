"""Share of the traced frames' wall time in which no operation ran on the
device (the union of kernel, copy and set intervals), %."""
from benchmark.harness import union_seconds


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace["device"] or ctx["trace_window_s"] <= 0:
        return None
    busy = union_seconds([(s, d) for _, s, d, _ in trace["device"]])
    return 100.0 * (1.0 - busy / ctx["trace_window_s"])
