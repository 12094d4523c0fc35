"""The port's occupancy grid (``lmsf_slam_tpu_torch.mapping.occupancy``)
against the reference (``lmsf_slam_tpu/mapping/occupancy.py``) on the inputs
of ``tests/test_occupancy.py``, on the CPU; then the backend's live grid and
its rebuild at a loop closure against the reference backend's.

Tolerance: log-odds grids equal to 1e-6 in every cell, except the cells
beside a ray sample that lies within 1e-5 m of a cell boundary (recomputed
here in float64): the cell of a sample is a float32 floor of
``origin + t·(point − origin)``, and XLA fuses that multiply-add where torch
rounds twice, so a sample exactly on a boundary may fall on either side. The
first test has no such sample and is exact; the wall of the second stands at
x = 5.0 seen from x = 0, so some of its samples sit on boundaries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import KeyframeDatabase as JDB
from lmsf_slam_tpu.common import se3 as jse3
from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
from lmsf_slam_tpu.datasets import make_sim_world as jmake_sim_world
from lmsf_slam_tpu.datasets import simulate_scan as jsimulate_scan
from lmsf_slam_tpu.mapping import occupancy as jocc
from lmsf_slam_tpu_torch.backend import KeyframeDatabase as PDB
from lmsf_slam_tpu_torch.backend import lifelong as pll
from lmsf_slam_tpu_torch.mapping import occupancy as pocc
from tests.test_torch_lifelong import drifted_odometry, loop_course, make_backends, reference_features
from tests.test_torch_registration import to_port
from tests import torch_threads  # noqa: F401

KEY = jax.random.PRNGKey(77)
CFG = dict(size=256, resolution=0.25)
TOL = 1e-6


def boundary_cells(origin, pts, mask, cfg, eps=1e-5):
    """Cells (as a bool grid) beside a free-space sample or an endpoint that
    lies within ``eps`` m of a cell boundary, in float64."""
    K, S, res = cfg.samples_per_ray, cfg.size, cfg.resolution
    t = (np.arange(K) + 0.5) / (K + 1)
    o, p = np.asarray(origin, np.float64), np.asarray(pts, np.float64)[np.asarray(mask)]
    xy = np.concatenate([(o + t[None, :, None] * (p[:, None, :] - o)).reshape(-1, 2), p])
    near = np.abs(xy / res - np.round(xy / res)) * res < eps  # (M,2): close to a line
    out = np.zeros((S, S), bool)
    for dx in (-1, 0):
        for dy in (-1, 0):
            c = np.floor(xy / res).astype(int) + S // 2
            c = c + np.where(near, np.round(xy / res).astype(int) + [dx, dy] - np.floor(
                xy / res).astype(int), 0)
            sel = near.any(axis=1) & np.all((c >= 0) & (c < S), axis=1)
            out[c[sel, 0], c[sel, 1]] = True
    return out


def test_config_and_init_match_reference():
    assert pocc.OccupancyConfig()._asdict() == jocc.OccupancyConfig()._asdict()
    g = pocc.occupancy_init(pocc.OccupancyConfig(**CFG), device="cpu")
    assert g.shape == (256, 256) and g.dtype == torch.float32 and not g.any()


def test_occupancy_update_matches_reference():
    jcfg, pcfg = jocc.OccupancyConfig(**CFG), pocc.OccupancyConfig(**CFG)
    world = jmake_sim_world(KEY, extent=20.0, n_boxes=8, n_cylinders=0)
    pose = jse3.make_pose(jse3.quat_identity(), jnp.asarray([0.0, 0.0, 1.0]))
    pb = jsimulate_scan(world, pose, KEY, rings=16, width=720, max_range=30.0, noise=0.0)
    w = jse3.pose_apply(pose, pb.xyz)
    mask = pb.mask & (w[:, 2] > jcfg.z_low) & (w[:, 2] < jcfg.z_high)
    jg = jocc.occupancy_init(jcfg)
    pg = pocc.occupancy_init(pcfg, device="cpu")
    origin = np.array([0.3, -0.2], np.float32)  # off a cell corner
    for _ in range(5):  # log-odds accumulate over repeated observations, up to the clip
        jg = jocc.occupancy_update(jg, jnp.asarray(origin), w[:, :2], mask, jcfg)
        pg = pocc.occupancy_update(pg, torch.as_tensor(origin), torch.as_tensor(np.array(w[:, :2])),
                                   torch.as_tensor(np.array(mask)), pcfg)
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=TOL)
    g = pg.numpy()
    assert (g > 0).sum() > 50 and (g < 0).sum() > 1000  # occupied and free cells
    assert g.min() >= pcfg.l_min and g.max() <= pcfg.l_max and g.max() == pcfg.l_max
    np.testing.assert_allclose(pocc.occupancy_probability(pg).numpy(),
                               np.asarray(jocc.occupancy_probability(jg)), atol=TOL)
    # points outside the grid and masked points leave no mark
    far = torch.tensor([[1e4, 0.0], [0.0, -1e4], [1.0, 1.0]])
    z = pocc.occupancy_update(pocc.occupancy_init(pcfg, "cpu"), torch.zeros(2), far,
                              torch.tensor([True, True, False]), pcfg)
    jz = jocc.occupancy_update(jocc.occupancy_init(jcfg), jnp.zeros(2), jnp.asarray(far.numpy()),
                               jnp.asarray([True, True, False]), jcfg)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=TOL)


def test_grid_from_database_matches_reference():
    """One wall segment observed from two keyframes (``tests/test_occupancy.py``)."""
    jcfg, pcfg = jocc.OccupancyConfig(**CFG), pocc.OccupancyConfig(**CFG)
    j = JDB(edge_capacity=8, surf_capacity=64, initial_keyframes=4)
    p = PDB(edge_capacity=8, surf_capacity=64, initial_keyframes=4, mirror_min_cap=4, device="cpu")
    wall = np.stack([np.full(32, 5.0), np.linspace(-2, 2, 32), np.full(32, 1.0)], 1).astype(
        np.float32)
    for i in range(2):
        pose = np.array([1.0, 0, 0, 0, 0.0, float(i), 0.0], np.float32)
        local = wall - pose[4:]
        j.add_keyframe(0.1 * i, pose, pose, JPB.empty(8), JPB.from_points(local, capacity=64))
        p.add_keyframe(0.1 * i, pose, pose, to_port(JPB.empty(8)),
                       to_port(JPB.from_points(local, capacity=64)))
    jg, pg = jocc.occupancy_from_database(j, jcfg), pocc.occupancy_from_database(p, pcfg)
    differ = np.abs(pg.numpy() - np.asarray(jg)) > TOL
    allowed = np.zeros_like(differ)
    for i in range(2):
        allowed |= boundary_cells([0.0, float(i)], wall[:, :2], np.ones(32, bool), pcfg)
    assert not (differ & ~allowed).any(), np.argwhere(differ & ~allowed)
    assert differ.sum() <= 4
    prob = pocc.occupancy_probability(pg).numpy()
    ci, cj = int(np.floor(5.0 / 0.25)) + 128, 128
    assert prob[ci, cj] > 0.6 and prob[128 + 8, cj] < 0.4


def test_backend_keeps_the_reference_grid_live_and_rebuilds_it_at_the_loop():
    """The closed course of ``tests/test_torch_lifelong.py`` through both
    backends with a 128 × 128 grid: the live grid agrees after every keyframe
    (1e-6 while mapping; after the loop closure the poses of the two
    packages differ by up to 5e-3 m, so a few boundary cells may differ: at
    most 3 % of the touched cells), the loop closure rebuilds it from the
    database (equal to ``occupancy_from_database`` then), and a backend
    booted on the filled database starts with the rebuilt grid."""
    occ = dict(size=128, resolution=0.5, samples_per_ray=32)
    traj, scans = loop_course()
    odom = drifted_odometry(traj)
    jb, pb = make_backends(lifelong=dict(occupancy=jocc.OccupancyConfig(**occ)))
    pb.config = pb.config._replace(occupancy=pocc.OccupancyConfig(**occ))
    pb._occ = pocc.occupancy_init(pb.config.occupancy, "cpu")
    assert pb.occupancy_grid() is not None and not pb.occupancy_grid().any()
    closed = False
    for i, s in enumerate(scans):
        e, su = jax.tree.map(np.asarray, reference_features(*map(jnp.asarray, s)))
        a = jb.add_keyframe(0.1 * i, e, su, odom[i])
        b = pb.add_keyframe(0.1 * i, to_port(e), to_port(su), odom[i])
        assert bool(a.loop_closed) == bool(b.loop_closed)
        jg, pg = np.asarray(jb.occupancy_grid()), pb.occupancy_grid().numpy()
        if not closed and not b.loop_closed:
            np.testing.assert_allclose(pg, jg, atol=TOL, err_msg=str(i))
        else:
            differ = (np.abs(pg - jg) > TOL).sum()
            assert differ <= 0.03 * (jg != 0).sum(), (i, differ)
        if b.loop_closed:
            closed = True
            rebuilt = pocc.occupancy_from_database(pb.db, pb.config.occupancy)
            np.testing.assert_array_equal(pg, rebuilt.numpy())
            assert "occ_rebuild" in pb.timer.stats()
    assert closed
    g = pb.occupancy_grid().numpy()
    assert (g > 0).any() and (g < 0).any() and g.min() >= -4.0 and g.max() <= 4.0
    booted = pll.LifelongBackend(db=pb.db, config=pb.config)
    assert booted.mode is pll.WorkMode.RELOCALIZATION
    np.testing.assert_array_equal(
        booted.occupancy_grid().numpy(),
        pocc.occupancy_from_database(pb.db, pb.config.occupancy).numpy())
    assert pll.LifelongBackend(db=PDB(device="cpu")).occupancy_grid() is None


@pytest.mark.parametrize("n", [1, 7])
def test_marks_do_not_depend_on_the_order_of_the_points(n):
    cfg = pocc.OccupancyConfig(size=32, resolution=1.0, samples_per_ray=8)
    rng = np.random.default_rng(n)
    pts = torch.as_tensor(rng.uniform(-20, 20, (50, 2)).astype(np.float32))
    mask = torch.as_tensor(rng.random(50) < 0.8)
    base = pocc.occupancy_update(pocc.occupancy_init(cfg, "cpu"), torch.zeros(2), pts, mask, cfg)
    perm = torch.as_tensor(rng.permutation(50))
    again = pocc.occupancy_update(pocc.occupancy_init(cfg, "cpu"), torch.zeros(2), pts[perm],
                                  mask[perm], cfg)
    assert torch.equal(base, again)
