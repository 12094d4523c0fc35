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
from .async_backend import AsyncBackend
from .session_merge import SessionAlignment, align_sessions, merge_sessions

__all__ += ["AsyncBackend", "SessionAlignment", "align_sessions", "merge_sessions"]
