"""Frozen city world, course and movers (numpy), a copy of the port's
``datasets/city.py``: a street grid of buildings and tree trunks, the
multi-loop KITTI-00-class drive over it, and cars shuttling along the
streets. The arrays feed :class:`.sim.Renderer`. Nothing of the program is
imported, so no change to it can move the benchmark's city.
"""
from __future__ import annotations

import math

import numpy as np

# HDL-64E geometry (KITTI sensor): 64 rings, −24.8°…+2° elevation, ~0.2°
# azimuth step at 10 Hz, mounted ≈1.73 m above ground.
HDL64 = dict(rings=64, width=1800, elev_min=-0.4328, elev_max=0.0349)
HDL64_SENSOR_Z = 1.73


def make_city_world(
    seed: int,
    blocks_x: int = 3,
    blocks_y: int = 2,
    block: float = 40.0,
    street: float = 12.0,
    buildings_per_block: int = 3,
    trees_per_street: int = 4,
):
    """Street-grid city.

    Intersections sit at ``(i·pitch, j·pitch)`` for ``i ∈ [0, blocks_x]``,
    ``j ∈ [0, blocks_y]`` with ``pitch = block + street``; streets run along
    those grid lines.  Each block interior holds a few buildings set back
    from the street; tree trunks / poles line the street edges (LOAM edge
    features — the role lamp posts play in real KITTI scans).

    ``seed`` is the integer that seeds ``numpy.random.default_rng`` (the
    reference draws it from a JAX key; given the same integer both packages
    build the same world, bit for bit).
    """
    pitch = block + street
    half_st = street / 2.0
    rng = np.random.default_rng(int(seed))

    bmin, bmax = [], []
    for bi in range(blocks_x):
        for bj in range(blocks_y):
            # block interior spans [i·pitch + half_st, (i+1)·pitch − half_st]
            x0 = bi * pitch + half_st + 1.0
            y0 = bj * pitch + half_st + 1.0
            inner = block - 2.0
            for _ in range(buildings_per_block):
                w = rng.uniform(8.0, 0.45 * inner)
                d = rng.uniform(8.0, 0.45 * inner)
                cx = x0 + rng.uniform(w / 2, inner - w / 2)
                cy = y0 + rng.uniform(d / 2, inner - d / 2)
                h = rng.uniform(4.0, 12.0)
                bmin.append([cx - w / 2, cy - d / 2, 0.0])
                bmax.append([cx + w / 2, cy + d / 2, h])

    cyl = []
    # trees along both edges of every street segment (offset just inside the
    # block margin so trunks don't block the carriageway)
    off = half_st - 1.0
    for bi in range(blocks_x + 1):  # vertical streets x = bi·pitch
        for bj in range(blocks_y):
            y0 = bj * pitch + half_st + 2.0
            for k in range(trees_per_street):
                y = y0 + (k + 0.5) * (block - 4.0) / trees_per_street
                for sx in (-off, off):
                    cyl.append([bi * pitch + sx + rng.uniform(-0.3, 0.3),
                                y + rng.uniform(-0.5, 0.5),
                                rng.uniform(0.05, 0.11), rng.uniform(3.0, 6.0)])
    for bj in range(blocks_y + 1):  # horizontal streets y = bj·pitch
        for bi in range(blocks_x):
            x0 = bi * pitch + half_st + 2.0
            for k in range(trees_per_street):
                x = x0 + (k + 0.5) * (block - 4.0) / trees_per_street
                for sy in (-off, off):
                    cyl.append([x + rng.uniform(-0.5, 0.5),
                                bj * pitch + sy + rng.uniform(-0.3, 0.3),
                                rng.uniform(0.05, 0.11), rng.uniform(3.0, 6.0)])

    return {"boxes_min": np.asarray(bmin, np.float32), "boxes_max": np.asarray(bmax, np.float32),
            "cylinders": np.asarray(cyl, np.float32), "ground_z": 0.0}


# A multi-loop route over grid intersections (units of pitch). Three distinct
# revisit events: the (0,0)…(1,1) block perimeter closes on itself, the cross
# leg re-enters (1,1), and the homeward leg re-drives the (1,0)→(0,0) street —
# the same topology class as KITTI 00's repeated-street loops.
DEFAULT_ROUTE = [
    (0, 0), (1, 0), (1, 1), (0, 1), (0, 0),      # loop A (perimeter)
    (1, 0), (2, 0), (2, 1), (1, 1),              # revisit (1,0)-(1,1) corners
    (1, 2), (0, 2), (0, 1), (0, 0),              # upper loop, revisit (0,1)
    (1, 0), (2, 0), (3, 0), (3, 1), (2, 1),      # east extension
    (2, 0), (1, 0), (0, 0),                       # home stretch, re-driven
    (0, 1), (1, 1), (2, 1), (2, 2), (1, 2),      # second tour, upper streets
    (1, 1), (1, 0), (0, 0),                       # final closure
]


def make_city_course(
    route=None,
    pitch: float = 52.0,
    speed: float = 0.9,
    corner_speed: float = 0.55,
    corner_radius: float = 7.0,
    sensor_z: float = HDL64_SENSOR_Z,
) -> np.ndarray:
    """Ground-truth poses (n, 7) [qw qx qy qz x y z] along a street route.

    Straight legs between intersections with circular-arc corners
    (``corner_radius``), walked at ``speed`` m/frame on straights and
    ``corner_speed`` in turns — 10 Hz car dynamics (KITTI drives ≈1 m/frame;
    90° corners take ~20 frames here ≈ 45°/s yaw rate).
    """
    route = route or DEFAULT_ROUTE
    wp = np.asarray([(i * pitch, j * pitch) for i, j in route], np.float64)

    # dense centerline: straight segments shortened by the corner radius,
    # corners as sampled arcs
    pts, is_corner = [], []

    def add_line(p0, p1):
        d = np.linalg.norm(p1 - p0)
        n = max(int(d / 0.25), 1)
        for t in np.linspace(0.0, 1.0, n, endpoint=False):
            pts.append(p0 + t * (p1 - p0))
            is_corner.append(False)

    for k in range(len(wp) - 1):
        p0, p1 = wp[k], wp[k + 1]
        u = (p1 - p0) / np.linalg.norm(p1 - p0)
        start = p0 + (u * corner_radius if k > 0 else 0.0)
        end = p1 - (u * corner_radius if k + 2 < len(wp) else 0.0)
        add_line(start, end)
        if k + 2 < len(wp):  # arc into the next leg
            v = wp[k + 2] - p1
            v = v / np.linalg.norm(v)
            cross = u[0] * v[1] - u[1] * v[0]
            if abs(cross) < 1e-6:  # straight-through intersection
                add_line(end, p1 + v * 0.0)
                continue
            # circle tangent to both legs at distance corner_radius from p1
            c = p1 - u * corner_radius + np.array([-u[1], u[0]]) * (
                corner_radius * np.sign(cross)
            )
            a0 = math.atan2(*(end - c)[::-1])
            a1 = math.atan2(*((p1 + v * corner_radius) - c)[::-1])
            sweep = (a1 - a0 + np.pi) % (2 * np.pi) - np.pi
            n = max(int(abs(sweep) * corner_radius / 0.25), 2)
            for t in np.linspace(0.0, 1.0, n, endpoint=False):
                a = a0 + t * sweep
                pts.append(c + corner_radius * np.array([np.cos(a), np.sin(a)]))
                is_corner.append(True)
    pts.append(wp[-1])
    is_corner.append(False)
    pts = np.asarray(pts)
    is_corner = np.asarray(is_corner)

    # walk the centerline at the speed profile
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    v_at = np.where(is_corner[:-1], corner_speed, speed)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    # frame arclengths: integrate ds = v(s) per frame
    frames = [0.0]
    while frames[-1] < s[-1]:
        i = min(np.searchsorted(s, frames[-1], side="right"), len(v_at)) - 1
        frames.append(frames[-1] + v_at[max(i, 0)])
    sf = np.asarray(frames[:-1])

    x = np.interp(sf, s, pts[:, 0])
    y = np.interp(sf, s, pts[:, 1])
    # heading from the path tangent (central difference, then unwrapped)
    dx = np.gradient(x)
    dy = np.gradient(y)
    yaw = np.unwrap(np.arctan2(dy, dx))
    q = np.stack(
        [np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw),
         np.sin(yaw / 2)], axis=-1,
    )
    t = np.stack([x, y, np.full_like(x, sensor_z)], axis=-1)
    return np.concatenate([q, t], axis=-1).astype(np.float32)


def make_movers(
    seed: int,
    blocks_x: int = 3,
    blocks_y: int = 2,
    pitch: float = 52.0,
    n_movers: int = 8,
    speed: float = 0.8,
    size=(4.2, 1.8, 1.5),
):
    """Dynamic objects (cars) shuttling along the streets.

    Returns ``mover_boxes(frame) -> (bmin (K,3), bmax (K,3))`` — per-frame
    axis-aligned boxes to concatenate onto the static world (fixed K, so the
    ray caster sees the same shapes every frame). ``seed`` seeds
    ``numpy.random.default_rng``, as in :func:`make_city_world`. Each mover ping-pongs along one street
    segment at ``speed`` m/frame, offset ~2 m from the street centerline so
    it shares the carriageway with the ego course — exactly the transient
    structure the dynamic-carving / unsupported-point stack must erase from
    the lifelong map.
    """
    rng = np.random.default_rng(int(seed))
    half = np.asarray(size, np.float32) / 2.0
    segs = []  # (p0 (2,), p1 (2,), lateral offset sign)
    for bi in range(blocks_x + 1):  # vertical streets
        for bj in range(blocks_y):
            p0 = np.array([bi * pitch, bj * pitch + 6.0])
            p1 = np.array([bi * pitch, (bj + 1) * pitch - 6.0])
            segs.append((p0, p1, np.array([2.0, 0.0])))
    for bj in range(blocks_y + 1):  # horizontal streets
        for bi in range(blocks_x):
            p0 = np.array([bi * pitch + 6.0, bj * pitch])
            p1 = np.array([(bi + 1) * pitch - 6.0, bj * pitch])
            segs.append((p0, p1, np.array([0.0, 2.0])))
    pick = rng.choice(len(segs), size=n_movers, replace=False)
    starts = rng.uniform(0.0, 1.0, n_movers)

    def mover_boxes(frame: int):
        bmin = np.zeros((n_movers, 3), np.float32)
        bmax = np.zeros((n_movers, 3), np.float32)
        for m, (si, s0) in enumerate(zip(pick, starts)):
            p0, p1, off = segs[si]
            length = float(np.linalg.norm(p1 - p0))
            # ping-pong parametrization along the segment
            u = (s0 + frame * speed / length) % 2.0
            u = u if u <= 1.0 else 2.0 - u
            c = p0 + u * (p1 - p0) + off
            bmin[m] = [c[0] - half[0], c[1] - half[1], 0.0]
            bmax[m] = [c[0] + half[0], c[1] + half[1], size[2]]
        return bmin, bmax

    return mover_boxes


def world_with_movers(world, mover_boxes, frame: int):
    """Static city + this frame's mover boxes (fixed total box count)."""
    bmin, bmax = mover_boxes(frame)
    return dict(world, boxes_min=np.concatenate([world["boxes_min"], bmin]),
                boxes_max=np.concatenate([world["boxes_max"], bmax]))
