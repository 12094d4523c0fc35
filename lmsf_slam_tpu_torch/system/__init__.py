from .ml_system import (  # noqa: F401
    FeatureParams,
    FrameResult,
    KeyframeGate,
    MultiLidarSystem,
    SystemConfig,
    build_featurize,
    tracker_config_for,
)
