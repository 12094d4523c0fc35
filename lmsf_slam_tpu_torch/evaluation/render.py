"""Map / pose-graph rendering — the inspectable artifact of a run.

Counterpart of ``lmsf_slam_tpu/evaluation/render.py``: a headless matplotlib
export of the top-down global map colored by height (single-hue sequential),
the keyframe trajectory, the odometry chain and loop-closure edges as a
distinct overlay; and the occupancy grid. matplotlib is imported inside each
function, so the package imports without it; the clouds come from the
database's device to the host once.
"""
from __future__ import annotations

import numpy as np


def render_map(
    db,
    path: str,
    est: np.ndarray | None = None,
    gt: np.ndarray | None = None,
    max_points: int = 400_000,
    title: str | None = None,
):
    """Write a top-down PNG of the global map + pose graph.

    ``db``: a KeyframeDatabase of the port (clouds at current optimized
    poses).
    ``est``/``gt``: optional per-frame trajectories (N, 7) drawn on top.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = db.n_keyframes
    fig, ax = plt.subplots(figsize=(10, 10), dpi=130)
    if n > 0:
        edge_pb, surf_pb = db.local_map_ids(np.arange(n))
        pts = np.concatenate([edge_pb.to_numpy(), surf_pb.to_numpy()])
        if pts.shape[0] > max_points:
            sel = np.random.default_rng(0).choice(
                pts.shape[0], max_points, replace=False
            )
            pts = pts[sel]
        z = pts[:, 2]
        zlo, zhi = np.percentile(z, [2, 98])
        # magnitude (height) = sequential single hue, light→dark; recessive
        # small markers so the structure reads, not the dots
        ax.scatter(
            pts[:, 0], pts[:, 1], c=np.clip(z, zlo, zhi), cmap="Blues",
            s=0.3, linewidths=0, alpha=0.55, rasterized=True,
        )
        kf = db.map_poses[:n, 4:]
        # odometry chain + loop edges from the graph
        eij = db.eij[: db.n_edges]
        eloop = db.eloop[: db.n_edges]
        for (i, j), lp in zip(eij, eloop):
            if lp:
                continue
            ax.plot(
                [kf[i, 0], kf[j, 0]], [kf[i, 1], kf[j, 1]],
                color="#c2410c", lw=1.0, alpha=0.9, zorder=3,
            )
        first_loop = True
        for (i, j), lp in zip(eij, eloop):
            if not lp:
                continue
            ax.plot(
                [kf[i, 0], kf[j, 0]], [kf[i, 1], kf[j, 1]],
                color="#7c3aed", lw=1.6, alpha=0.95, zorder=4,
                label="loop edge" if first_loop else None,
            )
            first_loop = False
        ax.scatter(
            kf[:, 0], kf[:, 1], c="#c2410c", s=5, zorder=5,
            label=f"keyframes ({n})",
        )
    if gt is not None:
        ax.plot(gt[:, 4], gt[:, 5], color="#6b7280", lw=1.2, ls="--",
                zorder=2, label="ground truth")
    if est is not None:
        ax.plot(est[:, 4], est[:, 5], color="#0f766e", lw=1.2, zorder=2,
                label="estimated path")
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    if title:
        ax.set_title(title)
    ax.legend(loc="upper right", framealpha=0.9, fontsize=9)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.grid(True, lw=0.3, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def render_occupancy(grid: np.ndarray, config, path: str):
    """Write the synchronized 2D occupancy grid as a PNG (log-odds →
    occupancy probability, single-hue sequential)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    prob = 1.0 / (1.0 + np.exp(-np.asarray(grid)))
    half = config.size * config.resolution / 2.0
    fig, ax = plt.subplots(figsize=(9, 9), dpi=130)
    im = ax.imshow(
        prob.T, origin="lower", cmap="Blues", vmin=0.0, vmax=1.0,
        extent=[-half, half, -half, half],
    )
    fig.colorbar(im, ax=ax, label="P(occupied)", shrink=0.8)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_title("synchronized occupancy grid")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
