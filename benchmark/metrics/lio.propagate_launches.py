"""Kernel launches a propagation in the traced frames: the runtime's launch
calls (``cudaLaunch*``, ``cuLaunch*``) that start inside one of the program's
``lio.propagate`` spans among the profiled frames, over the number of those
spans, launches/span. The device trace gives every launch call one thread, so
a span during which the backend's worker held a keyframe (``worker.keyframe``)
would count the worker's launches too: such spans are left out. None without
a trace or without a span the worker left alone."""
from benchmark.spans import spans

LAUNCHES = ("cudaLaunch", "cuLaunch")


def read(ctx):
    trace = ctx.get("trace")
    worker = spans(ctx, "worker.keyframe", profiled=True)
    props = [(a, b) for _, a, b in spans(ctx, "lio.propagate", profiled=True)
             if not any(wa < b and wb > a for _, wa, wb in worker)]
    if not trace or not props:
        return None
    inside = sum(1 for name, s, _, _ in trace["runtime"]
                 if name.startswith(LAUNCHES) and any(a <= s < b for a, b in props))
    return inside / len(props)
