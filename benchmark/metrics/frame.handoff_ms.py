"""Host milliseconds a window frame spends in the program's ``frame.handoff``
span of ``MultiLidarSystem.process`` (the keyframe gate, the submit to the
backend's worker (a wait for a queue slot included) and the
``FrameResult``): the spans of the window's frames outside the profiled
ones, summed, over those frames, ms."""
from benchmark.spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "frame.handoff")
