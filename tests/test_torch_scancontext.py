"""The port's scan context (``lmsf_slam_tpu_torch.ops.scancontext``) against
the reference (``lmsf_slam_tpu/ops/scancontext.py``) on the same numpy
inputs, on the CPU.

Tolerances: the descriptor is a max per bin of float32 values computed with
the same formulas, so it is bit-equal; ring keys and distances sum 20 or 60
float32 terms in another order, so 1e-6 and 1e-5; ids and shifts are exact,
ties included (the lowest index wins in both packages); yaws agree to 1e-6
rad (torch divides by a Python scalar through its reciprocal, one ulp from
the reference's division).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
from lmsf_slam_tpu.ops import scancontext as jsc
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch as PPB
from lmsf_slam_tpu_torch.ops import scancontext as psc
from tests import torch_threads  # noqa: F401


def cloud(seed, n=3000, spread=30.0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * np.array([spread, spread, 1.5], np.float32)
    xyz[::97] *= 4.0  # some points beyond max_range: the overflow bin
    mask = rng.random(n) < 0.9
    return xyz, mask


def both_sc(xyz, mask, **kw):
    want = np.asarray(jsc.make_scan_context(JPB(jnp.asarray(xyz), jnp.asarray(mask)), **kw))
    got = psc.make_scan_context(PPB(torch.as_tensor(xyz), torch.as_tensor(mask)), **kw).numpy()
    return got, want


def rotate_z(xyz, yaw):
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return xyz @ R.T


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_scan_context_is_bit_equal(seed):
    xyz, mask = cloud(seed)
    got, want = both_sc(xyz, mask)
    assert got.shape == (psc.RINGS, psc.SECTORS) == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 100


def test_make_scan_context_other_shape_and_empty_cloud():
    xyz, mask = cloud(3)
    got, want = both_sc(xyz, mask, rings=8, sectors=24)
    np.testing.assert_array_equal(got, want)
    got, want = both_sc(xyz, np.zeros_like(mask))
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_constants_match_reference():
    assert (psc.RINGS, psc.SECTORS, psc.MAX_RANGE, psc.Z_OFFSET) == (
        jsc.RINGS, jsc.SECTORS, jsc.MAX_RANGE, jsc.Z_OFFSET)


def database(n=40, pad=64, seed=10):
    """``n`` descriptors of random clouds padded to ``pad`` rows."""
    scs = np.zeros((pad, psc.RINGS, psc.SECTORS), np.float32)
    for i in range(n):
        scs[i] = both_sc(*cloud(seed + i, n=1500))[1]
    valid = np.arange(pad) < n
    return scs, np.array(jsc.ring_key(jnp.asarray(scs))), valid


def test_ring_key_matches_reference():
    scs, rk, _ = database(8, 8)
    np.testing.assert_allclose(psc.ring_key(torch.as_tensor(scs)).numpy(), rk, atol=1e-6)


def test_sc_distance_matches_reference():
    scs, _, _ = database(12, 12)
    q = np.roll(scs[3], 7, axis=1)
    dj, sj = jsc.sc_distance(jnp.asarray(q), jnp.asarray(scs))
    dp, sp = psc.sc_distance(torch.as_tensor(q), torch.as_tensor(scs))
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), atol=1e-5)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    assert sp.dtype == torch.int32
    assert dp.numpy()[3] < 1e-5 and int(sp[3]) == int(sj[3])
    # an empty query: every shift is meaningless, distance 2 at shift 0
    dj, sj = jsc.sc_distance(jnp.zeros_like(jnp.asarray(q)), jnp.asarray(scs))
    dp, sp = psc.sc_distance(torch.zeros_like(torch.as_tensor(q)), torch.as_tensor(scs))
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))


def search_both(q, scs, rk, valid, **kw):
    q, scs, rk, valid = (np.array(a) for a in (q, scs, rk, valid))
    want = jsc.sc_search(*(jnp.asarray(a) for a in (q, scs, rk, valid)), **kw)
    got = psc.sc_search(*(torch.as_tensor(a) for a in (q, scs, rk, valid)), **kw)
    return [np.asarray(g) for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("row,shift", [(5, 0), (17, 11), (33, 45)])
def test_sc_search_finds_the_rotated_row(row, shift):
    scs, rk, valid = database()
    q = np.roll(scs[row], shift, axis=1)
    got, want = search_both(q, scs, rk, valid)
    assert int(got[0]) == int(want[0]) == row
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    assert abs(float(got[2]) - float(want[2])) < 1e-6
    assert got[0].dtype == np.int32


def test_sc_search_of_a_rotated_scan_gives_the_yaw():
    """A scan and its copy rotated about z by 5 sectors' worth of yaw: the
    search returns the scan's row and the yaw that aligns them."""
    scs, rk, valid = database()
    xyz, mask = cloud(10 + 21, n=1500)  # the cloud of row 21
    yaw = 5 * 2 * math.pi / psc.SECTORS
    q = both_sc(rotate_z(xyz, yaw), mask)[1]
    got, want = search_both(q, scs, rk, valid)
    assert int(got[0]) == int(want[0]) == 21
    assert abs(float(got[2]) - float(want[2])) < 1e-6
    assert abs(abs(float(got[2])) - yaw) < 1e-5
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)


def test_sc_search_breaks_ties_by_lowest_index():
    """Three identical rows (equal ring keys and equal distances): both
    packages return the first of them; with fewer candidates than equal
    rows the candidate cut is also the lowest indices."""
    scs, rk, valid = database()
    for j in (30, 9, 22):
        scs[j], rk[j] = scs[14], rk[14]
    q = np.roll(scs[14], 3, axis=1)
    for k in (10, 2):
        got, want = search_both(q, scs, rk, valid, num_candidates=k)
        assert int(got[0]) == int(want[0]) == 9
        assert abs(float(got[2]) - float(want[2])) < 1e-6


def test_sc_search_on_an_empty_database_returns_minus_one():
    scs, rk, valid = database(6, 16)
    got, want = search_both(scs[2], scs, rk, np.zeros_like(valid))
    assert int(got[0]) == int(want[0]) == -1
    # and invalid rows are never returned, however close
    valid2 = valid.copy()
    valid2[2] = False
    got, want = search_both(scs[2], scs, rk, valid2)
    assert int(got[0]) == int(want[0]) != 2


def test_sc_search_id_takes_the_query_from_the_database():
    scs, rk, valid = database()
    scs[37] = np.roll(scs[4], 20, axis=1)
    rk[37] = rk[4]
    older = valid & (np.arange(valid.size) < 30)
    want = jsc.sc_search_id(jnp.int32(37), *(jnp.asarray(a) for a in (scs, rk, older)))
    got = psc.sc_search_id(37, *(torch.as_tensor(a) for a in (scs, rk, older)))
    assert int(got[0]) == int(want[0]) == 4
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-5)
    assert abs(float(got[2]) - float(want[2])) < 1e-6


def test_shift_to_yaw_matches_reference():
    s = np.arange(60, dtype=np.int32)
    np.testing.assert_allclose(psc.shift_to_yaw(torch.as_tensor(s)).numpy(),
                               np.asarray(jsc.shift_to_yaw(jnp.asarray(s))), atol=1e-6, rtol=0)
