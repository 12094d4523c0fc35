"""The port's dynamic-object ops (``lmsf_slam_tpu_torch.ops.dynamic``) against
the reference (``lmsf_slam_tpu/ops/dynamic.py``) on the inputs of
``tests/test_dynamic.py``, on the CPU.

``carve_dynamic`` and ``unsupported_mask`` take float32 decisions (a ring, a
column, three thresholds), so a point within rounding of a boundary may flip
between the packages. The masks must be equal except for points whose
decision margin, recomputed here in float64 from the same inputs, is under
1e-4: the distance of the ring coordinate to a half, of the column
coordinate to an integer, ``|measured − rng − tol|``, ``||m − rng| − sup_tol|``
at any of the nine neighbours, ``|range − min_range|``, ``|z − z_min|``, or
``|d − thresh²|`` for the gate. Every mismatch must be such a point.

The tracker with ``carve_map`` runs a few frames of a course with a moving
box against the float64 reference, as ``tests/test_torch_tracker.py`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.common import se3 as jse3
from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
from lmsf_slam_tpu.common.pointcloud import concat as jconcat
from lmsf_slam_tpu.datasets import make_sim_world as jmake_sim_world
from lmsf_slam_tpu.datasets import simulate_scan as jsimulate_scan
from lmsf_slam_tpu.ops import dynamic as jdyn
from lmsf_slam_tpu.ops import features as jf
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.datasets import SimWorld, simulate_scan
from lmsf_slam_tpu_torch.ops import dynamic as pdyn
from tests.test_torch_registration import to_port
from tests.test_torch_tracker import carve_course, port_grid
from tests import torch_threads  # noqa: F401

KEY = jax.random.PRNGKey(88)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def scene():
    """The set-up of ``tests/test_dynamic.py``: a scan of the simulated world
    from 1.5 m, its range image, and the scan in the world frame as map."""
    world = jmake_sim_world(KEY, extent=18.0, n_boxes=8, n_cylinders=10)
    pose = jse3.make_pose(jse3.quat_identity(), jnp.asarray([0.0, 0.0, 1.5]))
    scan = jsimulate_scan(world, pose, KEY, rings=16, width=720, max_range=40.0, noise=0.0)
    grid = jf.organize_scan(scan, rings=16, width=720)
    static_map = JPB(jse3.pose_apply(pose, scan.xyz), scan.mask)
    return world, pose, scan, grid, static_map


def carve_margins(grid, xyz, pose, elev_min=-0.26, elev_max=0.26, margin=0.3, min_range=1.0,
                  rel_margin=0.05, z_min=0.3):
    """(M,) the smallest decision margin of each map point, in float64."""
    rng_img, mask_img = np.asarray(grid.rng, np.float64), np.asarray(grid.mask)
    R, W = rng_img.shape
    pose = np.asarray(pose, np.float64)
    local = se3np.quat_rotate(se3np.quat_conj(pose[:4]), np.asarray(xyz, np.float64) - pose[4:])
    rng = np.linalg.norm(local, axis=-1)
    elev = np.arctan2(local[:, 2], np.maximum(np.linalg.norm(local[:, :2], axis=-1), 1e-6))
    az = np.arctan2(local[:, 1], local[:, 0])
    ring = (elev - elev_min) / (elev_max - elev_min) * (R - 1)
    col = (az + np.pi) / (2 * np.pi) * W
    m = np.minimum(np.abs(ring - np.floor(ring) - 0.5), np.abs(col - np.round(col)))
    m = np.minimum(m, np.minimum(np.abs(rng - min_range), np.abs(xyz[:, 2] - z_min)))
    ring_i = np.clip(np.round(ring), 0, R - 1).astype(int)
    col_i = np.clip(np.floor(col), 0, W - 1).astype(int)
    m = np.minimum(m, np.abs(rng_img[ring_i, col_i] - rng - (margin + rel_margin * rng)))
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            r_i, c_i = np.clip(ring_i + dr, 0, R - 1), (col_i + dc) % W
            sup = np.abs(np.abs(rng_img[r_i, c_i] - rng) - (margin + 0.02 * rng))
            m = np.minimum(m, np.where(mask_img[r_i, c_i], sup, np.inf))
    return m


def assert_masks_equal_up_to_margin(got, want, margins):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.bool_
    bad = got != want
    assert np.all(margins[bad] < MARGIN), (int(bad.sum()), margins[bad])
    assert bad.sum() <= max(2, got.size // 500)  # and such points are rare
    return int(bad.sum())


@pytest.mark.parametrize("case", ["defaults", "backend_limits"])
def test_carve_dynamic_matches_reference(scene, case):
    _, pose, scan, grid, static_map = scene
    rng = np.random.RandomState(0)
    car = (np.array([3.0, 0.5, 1.4]) + rng.randn(64, 3) * 0.3).astype(np.float32)
    test_map = jconcat([static_map, JPB.from_points(car, capacity=64)])
    kw = {}
    if case == "backend_limits":  # limits as the backend's hook derives them, another pose
        kw = dict(elev_min=-0.262, elev_max=0.259, margin=0.25, z_min=0.61)
        pose = jnp.asarray([0.9987503, 0.0, 0.0, 0.04997917, 0.4, -0.3, 1.5], jnp.float32)
    want = np.asarray(jdyn.carve_dynamic(grid, test_map, pose, **kw))
    got = pdyn.carve_dynamic(port_grid(jax.tree.map(np.asarray, grid)), to_port(test_map),
                             torch.as_tensor(np.asarray(pose)), **kw).numpy()
    margins = carve_margins(grid, np.asarray(test_map.xyz), np.asarray(pose), **kw)
    assert_masks_equal_up_to_margin(got, want, margins)
    cap = static_map.capacity
    if case == "defaults":  # the claims of tests/test_dynamic.py hold for the port
        assert got[cap:cap + 64].mean() < 0.3
        assert got[:cap][np.asarray(static_map.mask)].mean() > 0.97
    assert 0 < (~got).sum() < got.size


def test_carve_dynamic_takes_tensor_limits(scene):
    """The tracker hands the scan's own elevation limits over as 0-d tensors."""
    _, pose, _, grid, static_map = scene
    g, m, p = port_grid(jax.tree.map(np.asarray, grid)), to_port(static_map), torch.as_tensor(
        np.asarray(pose))
    a = pdyn.carve_dynamic(g, m, p, elev_min=-0.25, elev_max=0.25)
    b = pdyn.carve_dynamic(g, m, p, elev_min=torch.tensor(-0.25), elev_max=torch.tensor(0.25))
    assert torch.equal(a, b)
    empty = g._replace(mask=torch.zeros_like(g.mask))
    assert bool(pdyn.carve_dynamic(empty, m, p).all())  # no valid cell: nothing is carved


def test_unsupported_mask_matches_reference(scene):
    _, pose, scan, _, static_map = scene
    mover = np.array([4.0, -1.0, 1.2]) + np.random.RandomState(1).randn(32, 3) * 0.2
    mover_local = np.asarray(jse3.pose_apply(jse3.pose_inverse(pose),
                                             jnp.asarray(mover, jnp.float32)))
    scan_plus = jconcat([scan, JPB.from_points(mover_local, capacity=32)])
    want = np.asarray(jdyn.unsupported_mask(scan_plus, static_map, pose))
    got = pdyn.unsupported_mask(to_port(scan_plus), to_port(static_map),
                                torch.as_tensor(np.asarray(pose))).numpy()
    # margin: the exact 1-NN distance against the threshold, in float64
    world = se3np.quat_rotate(np.asarray(pose[:4], np.float64),
                              np.asarray(scan_plus.xyz, np.float64)) + np.asarray(pose[4:])
    ref = np.asarray(static_map.xyz, np.float64)[np.asarray(static_map.mask)]
    d = np.array([np.min(np.sum((ref - w) ** 2, axis=-1)) for w in world[np.asarray(want != got)]])
    margins = np.full(want.shape, np.inf)
    margins[want != got] = np.abs(d - 0.25)
    assert_masks_equal_up_to_margin(got, want, margins)
    assert got[scan.capacity:scan.capacity + 32].mean() > 0.9
    assert got[:scan.capacity][np.asarray(scan.mask)].mean() < 0.02


def test_tracker_carves_a_mover_like_the_reference():
    """Four frames past a box that drives along with the sensor, probation
    and ``carve_map`` on: pose and decisions against the float64 reference."""
    rng = np.random.default_rng(3)
    from lmsf_slam_tpu_torch.datasets import make_sim_world, make_trajectory

    world = make_sim_world(rng, extent=18.0, n_boxes=8, n_cylinders=14)
    traj = make_trajectory(30, radius=6.0, loop=False, device="cpu").numpy().copy()
    traj[:, 6] = 1.2
    scans = []
    for i in range(4):
        c = traj[i, 4:6] + np.array([3.0 + 0.5 * i, 1.5])  # the mover, 0.5 m a frame faster
        box = (np.array([[c[0] - 1.0, c[1] - 0.6, 0.0]], np.float32),
               np.array([[c[0] + 1.0, c[1] + 0.6, 1.5]], np.float32))
        w = SimWorld(np.concatenate([world.boxes_min, box[0]]),
                     np.concatenate([world.boxes_max, box[1]]), world.cylinders, world.ground_z)
        s = simulate_scan(w, traj[i], rng, rings=16, width=360, max_range=40.0, device="cpu")
        scans.append((s.xyz.numpy(), s.mask.numpy(), s.attr.numpy()))
    assert carve_course(scans, 4, variant=dict(probation=True)) > 500
