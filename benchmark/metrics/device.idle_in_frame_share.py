"""Share of the profiled frames' own time (the program's ``frame`` spans
among the traced frames) in which no operation ran on the device (the union
of kernel, copy and set intervals of the trace), %. Unlike
``device.idle_share`` it leaves out the time between frames."""
from benchmark.spans import covered_ns, spans


def read(ctx):
    trace = ctx.get("trace")
    frames = spans(ctx, "frame", profiled=True)
    if not trace or not trace["device"] or not frames:
        return None
    busy = [(s, s + d) for _, s, d, _ in trace["device"]]
    total = sum(e - s for _, s, e in frames)
    covered = sum(covered_ns(s, e, busy) for _, s, e in frames)
    return 100.0 * (1.0 - covered / total) if total > 0 else None
