"""Host milliseconds a window frame spends in the program's ``lio.deskew``
span of the IMU-aided step (``ops/preprocess.py::deskew`` of the edge and
surf clouds by the propagated motion): the spans of the window's frames
outside the profiled ones, summed, over those frames, ms. None where the
program records no such span."""
from benchmark.spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "lio.deskew")
