"""Host milliseconds a window frame spends in the program's ``frame.featurize``
span of ``MultiLidarSystem.process`` (preprocess, organize and the LOAM or
ICP features of the scans): the spans of the window's frames outside the
profiled ones, summed, over those frames, ms."""
from benchmark.spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "frame.featurize")
