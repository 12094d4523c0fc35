"""Points a frame where the host waits for the device, in the traced frames:
device-to-host copies plus stream, event and device synchronizes,
syncs/frame."""

WAITS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize")


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not ctx.get("trace_frames"):
        return None
    copies = sum(1 for name, *_ in trace["device"] if name.startswith("Memcpy DtoH"))
    waits = sum(1 for name, *_ in trace["runtime"] if name.startswith(WAITS))
    return (copies + waits) / ctx["trace_frames"]
