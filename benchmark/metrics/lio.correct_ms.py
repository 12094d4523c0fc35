"""Host milliseconds a window frame spends in the program's ``lio.correct``
span of the IMU-aided step (``estimator/eskf.py::eskf_update_pose`` and the
selection that keeps it where the solve was accepted): the spans of the
window's frames outside the profiled ones, summed, over those frames, ms.
None where the program records no such span."""
from benchmark.spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "lio.correct")
