"""Host milliseconds a window frame spends in the program's ``lio.propagate``
span of the IMU-aided step (``lio/lio_tracker.py``: the IMU window's one copy,
``eskf_run`` over its samples, the failure test and the masked reset): the
spans of the window's frames outside the profiled ones, summed, over those
frames, ms. None where the program records no such span."""
from benchmark.spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "lio.propagate")
