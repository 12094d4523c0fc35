from .schur import SubmapPartition, optimize_pose_graph_schur, partition_graph  # noqa: F401
