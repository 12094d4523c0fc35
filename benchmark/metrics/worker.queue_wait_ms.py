"""Mean milliseconds a keyframe waited in the backend's queue, from the
frame's submit to the worker taking it (the program's ``worker.queue_wait``
spans of the window, outside the profiled frames), ms."""
from benchmark.spans import spans


def read(ctx):
    waits = spans(ctx, "worker.queue_wait")
    return 1e3 * sum(s for s, _, _ in waits) / len(waits) if waits else None
