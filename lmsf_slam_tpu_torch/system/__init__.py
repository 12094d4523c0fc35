from .ml_system import (  # noqa: F401
    FeatureParams,
    FrameResult,
    KeyframeGate,
    MultiLidarSystem,
    SystemConfig,
    build_featurize,
    build_fused_step,
    read_frame,
    tracker_config_for,
)
