"""The port's simulator, preprocessing, voxel downsampling and LOAM feature
extraction against the reference, on the same numpy inputs, on the CPU.

Tolerances: masks, cell indices and voxel slot order exact; coordinates
atol 1e-6 (the same float32 formulas). The simulator's points get rtol 5e-5
plus atol 1e-4: its ray directions go through a 3×3 product whose float32
rounding is a few 1e-7 per component, and a grazing hit (a ray almost
parallel to a box face, or tangent to a cylinder) amplifies it along the
range (at atol 1e-4 alone, 23 of the 17280 coordinates of this test fail,
by at most 1.8e-5 of their value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
from lmsf_slam_tpu.datasets import simulator as jsim
from lmsf_slam_tpu.datasets import synthetic as jsyn
from lmsf_slam_tpu.ops import features as jf
from lmsf_slam_tpu.ops import preprocess as jp
from lmsf_slam_tpu.ops import voxel as jv
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch as PPB
from lmsf_slam_tpu_torch.datasets import make_sim_world, make_trajectory, simulate_scan
from lmsf_slam_tpu_torch.ops import features as pf
from lmsf_slam_tpu_torch.ops import preprocess as pp
from lmsf_slam_tpu_torch.ops import voxel as pv
from tests import torch_threads  # noqa: F401

W = 360


def _world_and_pose():
    world = make_sim_world(np.random.default_rng(0), extent=18.0, n_boxes=8, n_cylinders=14)
    traj = make_trajectory(60, radius=6.0, loop=False, device="cpu").numpy().copy()
    traj[:, 6] = 1.2
    return world, traj


def _jworld(world):
    return jsim.SimWorld(
        jnp.asarray(world.boxes_min), jnp.asarray(world.boxes_max),
        jnp.asarray(world.cylinders), jnp.float32(world.ground_z),
    )


def _scan(frame=3, seed=1, corrupt=True):
    """A sim scan (numpy), with some NaN and far returns when ``corrupt``."""
    world, traj = _world_and_pose()
    s = simulate_scan(world, traj[frame], np.random.default_rng(seed), rings=16, width=W,
                      max_range=40.0, device="cpu")
    xyz, mask, attr = s.xyz.numpy().copy(), s.mask.numpy().copy(), s.attr.numpy().copy()
    if corrupt:
        rng = np.random.default_rng(seed + 100)
        xyz[rng.choice(len(xyz), 40, replace=False)] = np.nan
        xyz[rng.choice(len(xyz), 40, replace=False)] *= 5.0  # beyond max_range
    return xyz, mask, attr


def _both(xyz, mask, attr):
    return JPB(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(attr)), PPB(
        torch.as_tensor(xyz), torch.as_tensor(mask), torch.as_tensor(attr))


def _assert_pb(pp_, jp_, atol=1e-6, rtol=0.0):
    np.testing.assert_array_equal(pp_.mask.numpy(), np.asarray(jp_.mask))
    np.testing.assert_allclose(pp_.xyz.numpy(), np.asarray(jp_.xyz), atol=atol, rtol=rtol)
    np.testing.assert_allclose(pp_.attr.numpy(), np.asarray(jp_.attr), atol=atol, rtol=0)


def test_trajectory_matches_reference():
    for loop in (True, False):
        want = np.asarray(jsyn.make_trajectory(25, radius=6.0, loop=loop))
        got = make_trajectory(25, radius=6.0, loop=loop, device="cpu").numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_simulator_matches_reference():
    """Same world, same pose, no noise: the same scan."""
    world, traj = _world_and_pose()
    zero = np.zeros(16 * W, np.float32)
    got = simulate_scan(world, traj[7], zero, rings=16, width=W, max_range=40.0, device="cpu")
    want = jsim.simulate_scan(_jworld(world), jnp.asarray(traj[7]), jax.random.PRNGKey(0), rings=16, width=W,
                              max_range=40.0, noise=0.0)
    _assert_pb(got, want, atol=1e-4, rtol=5e-5)
    assert got.mask.sum() > 0.5 * 16 * W


PREPROCESS = {
    "default": (jp.PreprocessParams(), pp.PreprocessParams(), None),
    "voxel": (jp.PreprocessParams(voxel_size=0.3), pp.PreprocessParams(voxel_size=0.3), 4096),
    "outlier": (jp.PreprocessParams(outlier_radius=0.6, outlier_min_neighbors=2),
                pp.PreprocessParams(outlier_radius=0.6, outlier_min_neighbors=2), None),
}


@pytest.mark.parametrize("name", sorted(PREPROCESS))
def test_preprocess_matches_reference(name):
    jparams, pparams, cap = PREPROCESS[name]
    jb, pb = _both(*_scan())
    _assert_pb(pp.preprocess(pb, pparams, cap), jp.preprocess(jb, jparams, cap))


def test_sweep_times_and_deskew_match_reference():
    jb, pb = _both(*_scan(corrupt=False))
    for cw in (True, False):
        np.testing.assert_allclose(
            pp.sweep_relative_times(pb, cw).numpy(),
            np.asarray(jp.sweep_relative_times(jb, cw)), atol=1e-6, rtol=0,
        )
    motion = np.array([0.9998, 0.0, 0.0, 0.02, 0.3, 0.05, 0.01], np.float32)
    motion[:4] /= np.linalg.norm(motion[:4])
    t = pb.attr[:, 0]
    got = pp.deskew(pb, t, torch.as_tensor(motion))
    want = jp.deskew(jb, jnp.asarray(t.numpy()), jnp.asarray(motion))
    _assert_pb(got, want, atol=1e-5)  # |p| ≤ 40 m: a float32 ulp is 4e-6


@pytest.mark.parametrize("voxel_size,cap", [(0.25, 4096), (0.5, 600)])
def test_voxel_downsample_matches_reference(voxel_size, cap):
    """Slot order is the reference's (ascending voxel key), and voxels past
    the capacity are dropped as the reference's segment_sum drops them."""
    jb, pb = _both(*_scan(corrupt=False))
    _assert_pb(pv.voxel_downsample(pb, voxel_size, cap), jv.voxel_downsample(jb, voxel_size, cap))


@pytest.mark.parametrize("voxel_size,cap", [(0.25, 4096), (0.5, 600)])
def test_voxel_downsample_summed_as_on_the_card(monkeypatch, voxel_size, cap):
    """CUDA tensors are summed in float64 (``_sum_dtype``), because the card
    adds in no fixed order. That arithmetic, run here on the CPU: it agrees
    with the reference to the tolerance of the float32 path (1e-6), and the
    result does not depend on the order of the points, bit for bit, over
    five shuffles of the cloud (a shuffle reorders the points inside every
    voxel, which is what the card's atomics do)."""
    monkeypatch.setattr(pv, "_sum_dtype", lambda xyz: torch.float64)
    xyz, mask, attr = _scan(corrupt=False)
    jb, pb = _both(xyz, mask, attr)
    first = pv.voxel_downsample(pb, voxel_size, cap)
    assert first.xyz.dtype == torch.float32 and first.attr.dtype == torch.float32
    _assert_pb(first, jv.voxel_downsample(jb, voxel_size, cap))
    origin = pv._snap_origin(pb.xyz, pb.mask, voxel_size)
    rng = np.random.default_rng(11)
    for _ in range(5):
        order = rng.permutation(len(xyz))
        _, shuffled = _both(xyz[order], mask[order], attr[order])
        assert torch.equal(pv._snap_origin(shuffled.xyz, shuffled.mask, voxel_size), origin)
        got = pv.voxel_downsample(shuffled, voxel_size, cap)
        assert torch.equal(got.mask, first.mask)
        assert torch.equal(got.xyz, first.xyz) and torch.equal(got.attr, first.attr)


def _grids():
    jb, pb = _both(*_scan())
    jb = jp.preprocess(jb)
    pb = pp.preprocess(pb)
    return jf.organize_scan(jb, rings=16, width=W), pf.organize_scan(pb, rings=16, width=W)


def test_organize_scan_matches_reference():
    jg, pg = _grids()
    np.testing.assert_array_equal(pg.flat_idx.numpy(), np.asarray(jg.flat_idx))
    np.testing.assert_array_equal(pg.mask.numpy(), np.asarray(jg.mask))
    np.testing.assert_array_equal(pg.xyz.numpy(), np.asarray(jg.xyz))
    np.testing.assert_allclose(pg.rng.numpy(), np.asarray(jg.rng), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(pg.attr.numpy(), np.asarray(jg.attr))


def test_curvature_and_masks_match_reference():
    jg, pg = _grids()
    cj, vj = jf.curvature(jg)
    cp, vp = pf.curvature(pg)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-6)
    for one_sided in (False, True):
        np.testing.assert_array_equal(
            pf.bad_point_mask(pg, one_sided).numpy(), np.asarray(jf.bad_point_mask(jg, one_sided))
        )
    np.testing.assert_array_equal(pf.ground_mask(pg).numpy(), np.asarray(jf.ground_mask(jg)))


FEATURES = {
    "default": {},
    "range_noise": {"range_noise": 0.01},
    "no_ground_edges": {"exclude_ground_edges": True},
    "one_sided": {"one_sided_occlusion": True, "edges_per_sector": 8},
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_extract_loam_features_matches_reference(name):
    jg, pg = _grids()
    kw = dict(sectors=6, edges_per_sector=4, surfs_per_sector=16) | FEATURES[name]
    jfeat = jf.extract_loam_features(jg, **kw)
    pfeat = pf.extract_loam_features(pg, **kw)
    for a, b in ((pfeat.edge, jfeat.edge), (pfeat.surf, jfeat.surf)):
        _assert_pb(a, b, atol=0)
    assert pfeat.edge.mask.sum() > 0 and pfeat.surf.mask.sum() > 0
