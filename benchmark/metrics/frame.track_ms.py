"""Host milliseconds a window frame spends in the program's ``frame.track``
span of ``MultiLidarSystem.process`` (``tracker_step``, or the IMU-aided
tracker's ``process_scan``): the spans of the window's frames outside the
profiled ones, summed, over those frames, ms."""
from benchmark.spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "frame.track")
