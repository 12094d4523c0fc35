from .pose_graph import PoseGraphParams, PoseGraphStats, optimize_pose_graph
from .keyframe_db import GraphArrays, KeyframeDatabase
from .loop_closure import LoopConfig, LoopDetector, LoopResult, RelocResult
from .lifelong import (
    BackendOutput,
    LifelongBackend,
    LifelongConfig,
    WorkMode,
)

__all__ = [
    "PoseGraphParams",
    "PoseGraphStats",
    "optimize_pose_graph",
    "GraphArrays",
    "KeyframeDatabase",
    "LoopConfig",
    "LoopDetector",
    "LoopResult",
    "RelocResult",
    "BackendOutput",
    "LifelongBackend",
    "LifelongConfig",
    "WorkMode",
]
