from .profiling import StageTimer  # noqa: F401
