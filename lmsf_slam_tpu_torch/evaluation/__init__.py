from .metrics import (  # noqa: F401
    TrajectoryStats,
    ate_stats,
    load_kitti_trajectory,
    rpe_stats,
    save_kitti_trajectory,
    umeyama_alignment,
)
from .render import render_map, render_occupancy  # noqa: F401
