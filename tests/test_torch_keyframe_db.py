"""The port's keyframe database (``lmsf_slam_tpu_torch.backend.keyframe_db``)
against the reference (``lmsf_slam_tpu/backend/keyframe_db.py``) fed the same
numpy keyframes, on the CPU.

Small sizes: clouds of 24 edge and 40 surf points, an initial capacity of 2
keyframes and a mirror floor of 4 rows, so a dozen keyframes grow the store
three times and the mirror twice. The host stores must hold the same bytes
(the descriptor is bit-equal; ring keys are a mean of 60 floats, 1e-6);
local maps transform points with float32 poses, 1e-5 m.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import keyframe_db as jdb
from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
from lmsf_slam_tpu_torch.backend import keyframe_db as pdb
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch as PPB
from lmsf_slam_tpu_torch.interop import (
    KEYFRAME_DB_EDGE_FIELDS,
    KEYFRAME_DB_FIELDS,
    keyframe_db_from_numpy,
)
from tests import torch_threads  # noqa: F401

EC, SC_ = 24, 40
KW = dict(edge_capacity=EC, surf_capacity=SC_, initial_keyframes=2, mirror_min_cap=4)
STORE = ("stamps", "odom_poses", "map_poses", "edge_xyz", "edge_mask", "surf_xyz", "surf_mask",
         "sc", "gnss_pos", "gnss_valid")


def keyframes(n, seed=0, ne=EC, ns=SC_):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pose = se3np.se3_exp(np.array([0.02 * i, -0.01 * i, 0.3 * i, 2.0 * i, 0.5 * i, 0.1]))
        out.append(dict(
            stamp=0.1 * i,
            odom=np.asarray(pose, np.float32),
            map=np.asarray(se3np.pose_compose(pose, se3np.se3_exp(np.full(6, 0.01))), np.float32),
            exyz=(rng.normal(size=(ne, 3)) * [10, 10, 1]).astype(np.float32),
            emask=rng.random(ne) < 0.8,
            sxyz=(rng.normal(size=(ns, 3)) * [15, 15, 1]).astype(np.float32),
            smask=rng.random(ns) < 0.9,
            gnss=np.array([i, 2.0 * i, 0.5], np.float32) if i % 3 == 0 else None,
        ))
    return out


def fill(n, **kw):
    """The same ``n`` keyframes and chain edges in both databases."""
    j = jdb.KeyframeDatabase(**KW)
    p = pdb.KeyframeDatabase(**KW, device="cpu")
    for i, k in enumerate(keyframes(n, **kw)):
        a = j.add_keyframe(k["stamp"], k["odom"], k["map"],
                           JPB(jnp.asarray(k["exyz"]), jnp.asarray(k["emask"])),
                           JPB(jnp.asarray(k["sxyz"]), jnp.asarray(k["smask"])), gnss_pos=k["gnss"])
        b = p.add_keyframe(k["stamp"], k["odom"], k["map"],
                           PPB(torch.as_tensor(k["exyz"]), torch.as_tensor(k["emask"])),
                           PPB(torch.as_tensor(k["sxyz"]), torch.as_tensor(k["smask"])),
                           gnss_pos=k["gnss"])
        assert a == b == i
        if i > 0:
            z = se3np.pose_between(k["map"], k["map"])
            for db in (j, p):
                db.add_edge(i - 1, i, z)
    return j, p


def assert_stores_equal(j, p):
    n, e = j.n_keyframes, j.n_edges
    assert (p.n_keyframes, p.n_edges) == (n, e)
    for name in STORE:
        got, want = getattr(p, name), getattr(j, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got[:n], want[:n], err_msg=name)
    np.testing.assert_allclose(p.ring_keys[:n], j.ring_keys[:n], atol=1e-6)
    for name in KEYFRAME_DB_EDGE_FIELDS:
        np.testing.assert_array_equal(getattr(p, name)[:e], getattr(j, name)[:e], err_msg=name)


def assert_mirror_equals_store(p):
    m = p._mirror_sync()
    n = p.n_keyframes
    assert m["n"] == n and m["cap"] >= max(n, p.mirror_min_cap)
    assert m["cap"] & (m["cap"] - 1) == 0
    for key, name in (("sc", "sc"), ("rk", "ring_keys"), ("poses", "map_poses"),
                      ("exyz", "edge_xyz"), ("emk", "edge_mask"), ("sxyz", "surf_xyz"),
                      ("smk", "surf_mask")):
        np.testing.assert_array_equal(m[key][:n].numpy(), getattr(p, name)[:n], err_msg=key)
        assert m[key].shape[0] == m["cap"]
    np.testing.assert_array_equal(m["pos"][:n].numpy(), p.map_poses[:n, 4:])
    np.testing.assert_array_equal(m["valid"].numpy(), np.arange(m["cap"]) < n)
    assert not m["emk"][n:].any() and not m["smk"][n:].any()


def test_stores_match_through_growth():
    j, p = fill(11)
    assert p.stamps.shape[0] == j.stamps.shape[0] == 16
    assert p.eij.shape[0] == j.eij.shape[0]
    assert_stores_equal(j, p)
    np.testing.assert_array_equal(p.positions(), j.positions())


def test_mirror_equals_store_after_every_append():
    """Rows are appended one sync at a time past the mirror's floor of 4
    rows (a whole upload at 5 and at 9), and several in one sync."""
    p = pdb.KeyframeDatabase(**KW, device="cpu")
    caps = []
    for i, k in enumerate(keyframes(10, seed=1)):
        p.add_keyframe(k["stamp"], k["odom"], k["map"],
                       PPB(torch.as_tensor(k["exyz"]), torch.as_tensor(k["emask"])),
                       PPB(torch.as_tensor(k["sxyz"]), torch.as_tensor(k["smask"])))
        if i not in (5, 6):  # keyframes 5..7 reach the mirror in one sync
            assert_mirror_equals_store(p)
            caps.append(p._mirror["cap"])
    assert caps == [4, 4, 4, 4, 8, 8, 16, 16]


def test_clouds_larger_than_the_capacity_are_clipped_in_both():
    j, p = fill(3, ne=EC + 7, ns=SC_ + 9)
    assert_stores_equal(j, p)
    assert p.edge_xyz.shape[1:] == (EC, 3)


def test_precomputed_descriptor_is_stored_as_given():
    j, p = jdb.KeyframeDatabase(**KW), pdb.KeyframeDatabase(**KW, device="cpu")
    k = keyframes(1, seed=2)[0]
    sc = np.random.default_rng(3).random((20, 60)).astype(np.float32)
    j.add_keyframe(0.0, k["odom"], k["map"], JPB(jnp.asarray(k["exyz"]), jnp.asarray(k["emask"])),
                   JPB(jnp.asarray(k["sxyz"]), jnp.asarray(k["smask"])), sc=sc)
    p.add_keyframe(0.0, k["odom"], k["map"],
                   PPB(torch.as_tensor(k["exyz"]), torch.as_tensor(k["emask"])),
                   PPB(torch.as_tensor(k["sxyz"]), torch.as_tensor(k["smask"])), sc=sc)
    assert_stores_equal(j, p)
    np.testing.assert_array_equal(p.sc[0], sc)


def test_add_edge_noise_and_loop_flag_match_reference():
    j, p = fill(4)
    z = se3np.se3_exp(np.array([0.01, 0.0, 0.2, 1.0, -2.0, 0.0]))
    for db in (j, p):
        db.add_edge(0, 3, z, noise=np.array([0.0025] * 3 + [0.01] * 3) * 0.49, loop=True)
        for _ in range(3):  # past the initial edge capacity
            db.add_edge(1, 2, z)
    assert_stores_equal(j, p)
    assert p.eloop[:p.n_edges].sum() == 1


@pytest.mark.parametrize("pad_min,pow2", [(0, True), (32, True), (0, False)])
def test_graph_arrays_padding_matches_reference(pad_min, pow2):
    j, p = fill(5)
    gj = j.graph_arrays(pad_to_pow2=pow2, pad_min=pad_min)
    gp = p.graph_arrays(pad_to_pow2=pow2, pad_min=pad_min)
    assert gp._fields == gj._fields
    for name in gp._fields:
        got, want = getattr(gp, name).numpy(), np.asarray(getattr(gj, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert gp.poses.shape[0] == (max(8, pad_min) if pow2 else 5)
    # padded edges point at vertex 0 with the mask off
    assert not gp.emask[p.n_edges:].any() and not gp.edges_ij[p.n_edges:].any()


def test_update_poses_reaches_the_mirror():
    j, p = fill(6)
    p._mirror_sync()
    new = p.map_poses[:6].copy()
    new[:, 4:] += 1.5
    for db in (j, p):
        db.update_poses(np.concatenate([new, np.zeros((10, 7), np.float32)]))
        db.update_poses_range(4, new[4:] + np.float32(0.25))
        db.update_poses_range(5, np.tile(new[:1], (4, 1)))  # runs past the end: clipped
    assert_stores_equal(j, p)
    assert_mirror_equals_store(p)
    assert p._mirror["pose_rev"] == p._pose_rev == 3


def test_carve_masks_the_store_and_the_mirror():
    j, p = fill(5)
    p._mirror_sync()
    rng = np.random.default_rng(5)
    ek, sk = rng.random(EC) < 0.5, rng.random(SC_) < 0.5
    for db in (j, p):
        db.carve(2, ek, sk)
    assert_stores_equal(j, p)
    assert p._dirty_rows == {2}
    assert_mirror_equals_store(p)
    assert not p._dirty_rows
    assert not (p.edge_mask[2] & ~ek).any()


def as_np(pb):
    return (pb.xyz.numpy() if isinstance(pb.xyz, torch.Tensor) else np.asarray(pb.xyz),
            pb.mask.numpy() if isinstance(pb.mask, torch.Tensor) else np.asarray(pb.mask))


def assert_maps_equal(got, want):
    for g, w in zip(got, want):
        (gx, gm), (wx, wm) = as_np(g), as_np(w)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_allclose(gx[gm], wx[wm], atol=1e-5)
        assert gx.shape == wx.shape


@pytest.mark.parametrize("center,half", [(0, 2), (4, 2), (8, 3), (5, 0)])
def test_local_map_device_equals_local_map_and_reference(center, half):
    j, p = fill(9)
    dev = p.local_map_device(center, half)
    assert_maps_equal(dev, j.local_map_device(center, half))
    # the device flavour is the host flavour plus a masked tail
    host = p.local_map(center, half)
    assert_maps_equal(host, j.local_map(center, half))
    for d, h in zip(dev, host):
        (dx, dm), (hx, hm) = as_np(d), as_np(h)
        np.testing.assert_allclose(dx[dm], hx[hm], atol=1e-6)
        assert dx.shape[0] == (2 * half + 1) * (EC if d is dev[0] else SC_)


def test_local_map_ids_and_keyframe_clouds_match_reference():
    j, p = fill(7)
    ids = np.array([5, 1, 3])
    assert_maps_equal(p.local_map_ids(ids), j.local_map_ids(ids))
    assert_maps_equal(p.local_map_ids_device(ids, 5), j.local_map_ids_device(ids, 5))
    for got, want in zip(p.keyframe_clouds(4), j.keyframe_clouds(4)):
        np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("k,max_id", [(1, None), (3, None), (3, 4), (6, 2), (20, None), (2, 0)])
def test_nearest_ids_and_knn_local_map_match_reference(k, max_id):
    j, p = fill(9)
    q = np.array([7.0, 2.0, 0.0], np.float32)
    ij, dj = j.nearest_ids(q, k, max_id=max_id)
    ip, dp = p.nearest_ids(q, k, max_id=max_id)
    np.testing.assert_array_equal(ip, ij)
    np.testing.assert_allclose(dp, dj, rtol=1e-6)
    assert len(ip) == min(k, 9 if max_id is None else max_id)
    assert_maps_equal(p.local_map_knn_device(q, k, max_id=max_id),
                      j.local_map_knn_device(q, k, max_id=max_id))


def test_nearest_ids_breaks_ties_by_lowest_id():
    j, p = fill(6)
    same = p.map_poses[:6].copy()
    same[[1, 4, 5], 4:] = same[2, 4:]
    for db in (j, p):
        db.update_poses(same)
    ij, _ = j.nearest_ids(same[2, 4:], 3)
    ip, dp = p.nearest_ids(same[2, 4:], 3)
    np.testing.assert_array_equal(ip, ij)
    np.testing.assert_array_equal(ip, [1, 2, 4])
    assert (dp == 0).all()


def test_descriptor_arrays_are_the_mirror():
    _, p = fill(5)
    sc, rk, valid = p.descriptor_arrays()
    assert sc.shape == (8, 20, 60) and rk.shape == (8, 20)
    np.testing.assert_array_equal(sc[:5].numpy(), p.sc[:5])
    np.testing.assert_array_equal(valid.numpy(), np.arange(8) < 5)


def test_database_carried_across_holds_the_same_bytes():
    j, p = fill(7)
    j.add_edge(0, 6, se3np.pose_identity(), loop=True)
    fields = {k: np.asarray(getattr(j, k)) for k in KEYFRAME_DB_FIELDS + KEYFRAME_DB_EDGE_FIELDS}
    fields.update(n_keyframes=j.n_keyframes, n_edges=j.n_edges)
    c = keyframe_db_from_numpy(fields, device="cpu", mirror_min_cap=4)
    assert (c.edge_capacity, c.surf_capacity, c.sc_shape) == (EC, SC_, (20, 60))
    assert_stores_equal(j, c)
    np.testing.assert_array_equal(c.ring_keys[:7], j.ring_keys[:7])
    assert_mirror_equals_store(c)
    c.add_edge(1, 2, se3np.pose_identity())  # and it keeps growing
    assert c.n_edges == j.n_edges + 1
    with pytest.raises(KeyError, match="eloop"):
        fields.pop("eloop")
        keyframe_db_from_numpy(fields, device="cpu")


def test_persistence_is_not_ported_yet(tmp_path):
    """Persistence is ported (``tests/test_torch_persistence.py`` holds it
    against the reference; the name is kept from when these calls raised): a
    saved database loads back equal, and a ``storage_dir`` backs the payload
    with memmaps."""
    _, p = fill(2)
    p.save(str(tmp_path / "db.npz"))
    q = pdb.KeyframeDatabase.load(str(tmp_path / "db.npz"), device="cpu")
    assert_stores_equal(p, q)
    assert q.device.type == "cpu" and q.storage_dir is None
    d = pdb.KeyframeDatabase(storage_dir=str(tmp_path / "payload"), device="cpu")
    assert isinstance(d.edge_xyz, np.memmap) and not isinstance(d.map_poses, np.memmap)
    assert (tmp_path / "payload" / "surf_xyz.dat").exists()
