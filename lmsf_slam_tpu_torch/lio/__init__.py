from .lio_tracker import LioConfig, LioTracker  # noqa: F401
