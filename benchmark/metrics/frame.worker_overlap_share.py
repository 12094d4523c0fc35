"""Share of the window frames' time (the program's ``frame`` spans, outside
the profiled frames) during which the backend's worker held a keyframe (a
``worker.keyframe`` span of another thread was open), %."""
from benchmark.spans import covered_ns, spans


def read(ctx):
    frames = spans(ctx, "frame")
    if not frames:
        return None
    work = spans(ctx, "worker.keyframe") + spans(ctx, "worker.keyframe", profiled=True)
    total = sum(e - s for _, s, e in frames)
    held = sum(covered_ns(s, e, [(ws, we) for w, ws, we in work if w.thread != f.thread])
               for f, s, e in frames)
    return 100.0 * held / total if total > 0 else None
