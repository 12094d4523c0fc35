from .profiling import StageTimer, device_trace  # noqa: F401
