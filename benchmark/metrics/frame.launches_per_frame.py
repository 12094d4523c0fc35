"""Kernels launched on the device a frame in the traced frames (both the
frame's thread and the backend's worker), launches/frame."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not ctx.get("trace_frames"):
        return None
    n = sum(1 for name, *_ in trace["device"] if not name.startswith(("Memcpy", "Memset")))
    return n / ctx["trace_frames"]
