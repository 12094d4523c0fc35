"""Host milliseconds a window frame spends in the program's ``frame.read_back``
span of ``MultiLidarSystem.process`` (the one packed copy of pose and flags
to the host, which waits for the device and for the worker's work queued
ahead of it on the one stream): the spans of the window's frames outside the
profiled ones, summed, over those frames, ms."""
from benchmark.spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "frame.read_back")
