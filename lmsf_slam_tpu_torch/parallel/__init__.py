from . import multihost
from .distributed import (
    Mesh,
    make_mesh,
    optimize_pose_graph_sharded,
    register_frames_batched,
    slam_training_step,
)
from .schur import SubmapPartition, optimize_pose_graph_schur, partition_graph

__all__ = [
    "Mesh",
    "SubmapPartition",
    "make_mesh",
    "multihost",
    "optimize_pose_graph_sharded",
    "optimize_pose_graph_schur",
    "partition_graph",
    "register_frames_batched",
    "slam_training_step",
]
