"""LOAM features of a raw scan: range filter → (ring, azimuth) range image →
curvature → occlusion / parallel-beam / ground rejection → per-(ring, sector)
top-k edges and surfs. A frozen plain copy of the port's
``ops/preprocess.py::preprocess`` (range filter) and ``ops/features.py``,
with the same tie rules (scatter-min keeps the lowest source index, a stable
sort puts lower indices first), so that at the scan's float32 it selects the
same points from the same scan.

``feature`` is the configuration's feature block: rings, width, sectors,
edges_per_sector, surfs_per_sector, edge_thresh, surf_thresh, nms_half,
range_noise, exclude_ground_edges, one_sided_occlusion.
"""
from __future__ import annotations

import math

import torch

INF = 3.4e38
INT_MAX = 2**31 - 1

FEATURE_DEFAULTS = dict(rings=16, width=900, sectors=6, edges_per_sector=4, surfs_per_sector=16,
                        edge_thresh=0.5, surf_thresh=0.05, nms_half=5, range_noise=0.0,
                        exclude_ground_edges=False, one_sided_occlusion=False)


def _segment_min(values, seg, n, fill):
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, seg.long(), values, reduce="amin", include_self=False)


def range_filter(xyz, mask, min_range, max_range):
    finite = torch.isfinite(xyz).all(dim=-1)
    xyz = torch.nan_to_num(xyz)
    r = torch.linalg.vector_norm(xyz, dim=-1)
    mask = mask & finite & (r > min_range) & (r < max_range)
    return torch.where(mask[:, None], xyz, 0.0), mask


def organize(xyz, mask, rings, width, times=None):
    """(grid xyz (R,W,3), range (R,W), mask (R,W)), and with ``times`` (N,)
    the grid's times (R,W) after them: each cell's from the point it keeps."""
    rng = torch.linalg.vector_norm(xyz, dim=-1)
    horiz = torch.linalg.vector_norm(xyz[:, :2], dim=-1)
    elev = torch.atan2(xyz[:, 2], torch.clamp(horiz, min=1e-6))
    lo = torch.min(torch.where(mask, elev, math.inf))
    hi = torch.max(torch.where(mask, elev, -math.inf))
    span = torch.clamp(hi - lo, min=1e-6)
    ring = torch.clamp(((elev - lo) / span * rings).to(torch.int32), 0, rings - 1)
    az = torch.atan2(xyz[:, 1], xyz[:, 0])
    col = torch.clamp(((az + math.pi) / (2 * math.pi) * width).to(torch.int32), 0, width - 1)
    n = rings * width
    cell = torch.where(mask, ring * width + col, n)
    best = _segment_min(torch.where(mask, rng, INF), cell, n + 1, INF)[:-1]
    src = torch.arange(xyz.shape[0], dtype=torch.int32, device=xyz.device)
    winner = mask & (rng <= best[torch.clamp(cell, 0, n - 1).long()] + 1e-7)
    cidx = _segment_min(torch.where(winner, src, INT_MAX), cell, n + 1, INT_MAX)[:-1]
    occ = cidx < INT_MAX
    ci = torch.clamp(cidx, 0, xyz.shape[0] - 1).long()
    grid = (xyz[ci].reshape(rings, width, 3), torch.where(occ, best, 0.0).reshape(rings, width),
            occ.reshape(rings, width))
    return grid if times is None else grid + (times[ci].reshape(rings, width),)


def _roll(x, s):
    return torch.roll(x, s, dims=1)


def _curvature(g_xyz, g_rng, g_mask, half):
    W = g_rng.shape[1]
    acc = torch.zeros_like(g_xyz)
    valid = g_mask
    for s in range(1, half + 1):
        for sg in (s, -s):
            acc = acc + (_roll(g_xyz, sg) - g_xyz)
            valid = valid & _roll(g_mask, sg)
    spacing = torch.clamp(g_rng * (2.0 * math.pi / W), min=1e-4)
    return torch.sum(acc * acc, dim=-1) / (2.0 * half * spacing) ** 2, valid


def _good(g_rng, g_mask, one_sided):
    r, rp, rn = g_rng, _roll(g_rng, 1), _roll(g_rng, -1)
    if one_sided:
        occluded = ((rp - r) < -(0.02 * r + 0.1)) | ((rn - r) < -(0.02 * r + 0.1))
    else:
        occluded = torch.maximum(torch.abs(r - rp), torch.abs(r - rn)) > (0.02 * r + 0.1)
    parallel = (torch.abs(rn + rp - 2 * r) > 0.02 * r + 0.05) & (
        torch.sign(rn - r) == torch.sign(rp - r))
    ok = g_mask & _roll(g_mask, 1) & _roll(g_mask, -1) & ~(occluded & parallel)
    return ok & ~occluded


def _ground(g_xyz, g_mask, max_angle=0.175, z_max=-0.5):
    d = g_xyz[1:] - g_xyz[:-1]
    ang = torch.atan2(torch.abs(d[..., 2]),
                      torch.clamp(torch.linalg.vector_norm(d[..., :2], dim=-1), min=1e-6))
    low = (g_xyz[..., 2] < z_max) & g_mask
    flat = (ang < max_angle) & low[1:] & low[:-1]
    g = torch.zeros_like(g_mask)
    g[:-1] = flat
    g[1:] = g[1:] | flat
    return g


def _top_k(score, k):
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def range_image(xyz, mask, feature: dict, min_range: float, max_range: float):
    """The scan's range image (grid xyz (R,W,3), range (R,W), mask (R,W))
    after the range filter: what the system carves with."""
    f = dict(FEATURE_DEFAULTS, **feature)
    xyz, mask = range_filter(xyz, mask, min_range, max_range)
    return organize(xyz, mask, f["rings"], f["width"])


def loam_features(xyz, mask, feature: dict, min_range: float, max_range: float, times=None):
    """((edge xyz, edge mask), (surf xyz, surf mask)) of a raw scan, sensor
    frame, in slot order (ring, sector, rank): the port's layout. With the
    scan's per-point sweep ``times`` (N,), each pair gains the features'
    times as a third member."""
    f = dict(FEATURE_DEFAULTS, **feature)
    xyz, mask = range_filter(xyz, mask, min_range, max_range)
    g_xyz, g_rng, g_mask, *g_times = organize(xyz, mask, f["rings"], f["width"], times)
    R, W = g_rng.shape
    half = f["nms_half"]
    c, cvalid = _curvature(g_xyz, g_rng, g_mask, half)
    c_edge = c
    if f["range_noise"] > 0.0:
        spacing = torch.clamp(g_rng * (2.0 * math.pi / W), min=1e-4)
        c_edge = c - 3.0 * ((2 * half + 1) / (2 * half) * (f["range_noise"] / spacing) ** 2)
    good = _good(g_rng, g_mask, f["one_sided_occlusion"]) & cvalid
    edge_ok = good & ~_ground(g_xyz, g_mask) if f["exclude_ground_edges"] else good
    cm = torch.where(edge_ok, c_edge, -INF)
    local_max = cm
    for s in range(1, half + 1):
        local_max = torch.maximum(local_max, _roll(cm, s))
        local_max = torch.maximum(local_max, _roll(cm, -s))
    peak = (cm >= local_max) & edge_ok
    S = f["sectors"]
    sw = W // S
    ce = c_edge.reshape(R, S, sw)
    e_val, e_idx = _top_k(torch.where((ce > f["edge_thresh"]) & peak.reshape(R, S, sw), ce, -INF),
                          f["edges_per_sector"])
    cs = c.reshape(R, S, sw)
    s_val, s_idx = _top_k(torch.where((cs < f["surf_thresh"]) & good.reshape(R, S, sw), -cs, -INF),
                          f["surfs_per_sector"])
    base = torch.arange(S, device=xyz.device)[None, :, None] * sw
    ring = torch.arange(R, device=xyz.device)[:, None, None]

    def gather(idx, vals):
        cols = idx + base
        pts = g_xyz[ring.expand(cols.shape), cols]
        out = (pts.reshape(-1, 3), (vals > -INF / 2).reshape(-1))
        return out + tuple(t[ring.expand(cols.shape), cols].reshape(-1) for t in g_times)

    return gather(e_idx, e_val), gather(s_idx, s_val)
