"""Persistence of the port's lifelong database
(``lmsf_slam_tpu_torch.backend.keyframe_db.KeyframeDatabase.save`` / ``load``,
``storage_dir``) against the reference's, on the CPU.

A checkpoint is the reference's format (same keys, dtypes, ``version=2``), so
each package must load what the other wrote: RAM checkpoints (one npz) and
disk-backed ones (memmap payload beside a small npz). Arrays are compared for
equality, bit for bit (ring keys to 1e-6 where the two packages computed
them; equal where one loaded the other's). The port also loads the city
database that the reference wrote (``eval_out_city/city_db.npz``: 255
keyframes at HDL-64 widths) with every array equal to the reference's own
load. A backend loaded from a checkpoint boots in RELOCALIZATION and
relocalizes where the reference does (decisions equal, poses to 5e-2 m, as
``tests/test_torch_lifelong.py``).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import keyframe_db as jdb
from lmsf_slam_tpu.backend import lifelong as jll
from lmsf_slam_tpu.common.pointcloud import PointBatch as JPB
from lmsf_slam_tpu_torch.backend import keyframe_db as pdb
from lmsf_slam_tpu_torch.backend import lifelong as pll
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch as PPB
from lmsf_slam_tpu_torch.system import MultiLidarSystem
from tests.test_torch_keyframe_db import (
    EC, KW, SC_, STORE, assert_mirror_equals_store, assert_stores_equal, keyframes,
)
from tests.test_torch_lifelong import assert_same_decisions, make_backends
from tests.test_torch_registration import to_port
from tests import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CITY_DB = os.path.join(ROOT, "eval_out_city", "city_db.npz")
EDGE_FIELDS = ("eij", "ez", "esqrtw", "eloop")
PAYLOAD = ("edge_xyz", "edge_mask", "surf_xyz", "surf_mask", "sc")


def fill_into(j, p, n, start=0):
    """Keyframes ``start..n-1`` of the seeded set and their chain edges into a
    reference database ``j`` and / or a port database ``p`` (either may be
    None)."""
    for i, k in enumerate(keyframes(n)):
        if i < start:
            continue
        if j is not None:
            j.add_keyframe(k["stamp"], k["odom"], k["map"],
                           JPB(jnp.asarray(k["exyz"]), jnp.asarray(k["emask"])),
                           JPB(jnp.asarray(k["sxyz"]), jnp.asarray(k["smask"])),
                           gnss_pos=k["gnss"])
        if p is not None:
            p.add_keyframe(k["stamp"], k["odom"], k["map"],
                           PPB(torch.as_tensor(k["exyz"]), torch.as_tensor(k["emask"])),
                           PPB(torch.as_tensor(k["sxyz"]), torch.as_tensor(k["smask"])),
                           gnss_pos=k["gnss"])
        if i > 0:
            for db in (j, p):
                if db is not None:
                    db.add_edge(i - 1, i, se3np.se3_exp(np.full(6, 0.01 * i)), loop=(i % 4 == 0))


def assert_same_database(a, b):
    """Two databases of either package hold the same rows, bit for bit."""
    n, e = a.n_keyframes, a.n_edges
    assert (b.n_keyframes, b.n_edges) == (n, e)
    assert (a.edge_capacity, a.surf_capacity, tuple(a.sc_shape)) == (
        b.edge_capacity, b.surf_capacity, tuple(b.sc_shape))
    for name in STORE + ("ring_keys",):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(np.asarray(x[:n]), np.asarray(y[:n]), err_msg=name)
    for name in EDGE_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x[:e], y[:e], err_msg=name)


def npz_spec(path):
    with np.load(path) as z:
        return {k: (z[k].dtype, z[k].shape) for k in z.files}


@pytest.mark.skipif(not os.path.exists(CITY_DB), reason="the city database artifact is absent")
def test_port_loads_the_city_database_the_reference_wrote():
    j = jdb.KeyframeDatabase.load(CITY_DB)
    p = pdb.KeyframeDatabase.load(CITY_DB, device="cpu")
    assert p.device.type == "cpu" and p.storage_dir is None
    assert (p.n_keyframes, p.n_edges) == (255, 259)
    assert (p.edge_capacity, p.surf_capacity) == (1536, 3072)
    assert_same_database(j, p)
    # the mirror fills from the loaded store (512 rows of 64,825 bytes)
    m = p._mirror_sync()
    assert m["cap"] == 512 and m["n"] == 255
    np.testing.assert_array_equal(m["exyz"][:255].numpy(), p.edge_xyz[:255])
    np.testing.assert_array_equal(m["smk"][:255].numpy(), p.surf_mask[:255])
    assert pll.LifelongBackend(db=p).mode is pll.WorkMode.RELOCALIZATION


@pytest.mark.parametrize("storage", ["ram", "memmap"])
def test_each_package_loads_the_others_checkpoint(tmp_path, storage):
    jdir, pdir = ((str(tmp_path / "j_payload"), str(tmp_path / "p_payload"))
                  if storage == "memmap" else (None, None))
    j = jdb.KeyframeDatabase(**KW, storage_dir=jdir)
    p = pdb.KeyframeDatabase(**KW, storage_dir=pdir, device="cpu")
    fill_into(j, p, 7)  # grows the store (and the memmap files) past 2 and 4 rows
    assert_stores_equal(j, p)
    assert isinstance(p.edge_xyz, np.memmap) == (storage == "memmap")
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    j.save(jpath)
    p.save(ppath)
    # same keys, dtypes and shapes (strings differ in length with the path)
    js, ps = npz_spec(jpath), npz_spec(ppath)
    assert js.keys() == ps.keys()
    for k in js:
        if k != "payload_dir":
            assert js[k] == ps[k], k
    with np.load(ppath) as z:
        assert int(z["version"]) == 2 and str(z["storage"]) == storage
        assert z["storage"].shape == () and z["stamps"].dtype == np.float64
        assert z["eloop"].dtype == np.bool_ and z["gnss_valid"].dtype == np.bool_
        if storage == "ram":
            assert z["edge_mask"].dtype == np.bool_
        else:
            assert str(z["payload_dir"]) == os.path.abspath(pdir)
    loaded = {
        "reference loads the port's": jdb.KeyframeDatabase.load(ppath),
        "port loads the reference's": pdb.KeyframeDatabase.load(jpath, device="cpu"),
        "port loads its own": pdb.KeyframeDatabase.load(ppath, device="cpu"),
    }
    for name, db in loaded.items():
        src = j if name == "port loads the reference's" else p
        assert_same_database(src, db)
        assert isinstance(db.edge_xyz, np.memmap) == (storage == "memmap"), name
    mine = loaded["port loads its own"]
    assert mine.device.type == "cpu"
    assert_mirror_equals_store(mine)
    if storage == "memmap":  # loaded into a session directory beside the checkpoint
        assert mine.storage_dir == os.path.splitext(os.path.abspath(ppath))[0] + "_session"
        assert loaded["port loads the reference's"].storage_dir.endswith("j_session")


def test_memmap_database_grows_past_its_first_capacity(tmp_path):
    d = str(tmp_path / "payload")
    p = pdb.KeyframeDatabase(**KW, storage_dir=d, device="cpu")
    ram = pdb.KeyframeDatabase(**KW, device="cpu")
    fill_into(None, p, 11)
    fill_into(None, ram, 11)
    assert p.stamps.shape[0] == 16 and p.edge_xyz.shape[0] == 16
    assert os.path.getsize(os.path.join(d, "edge_xyz.dat")) == 16 * EC * 3 * 4
    assert os.path.getsize(os.path.join(d, "surf_mask.dat")) == 16 * SC_
    for name in PAYLOAD:
        assert isinstance(getattr(p, name), np.memmap) and getattr(p, name).filename.endswith(
            name + ".dat")
    assert_same_database(ram, p)
    assert_mirror_equals_store(p)  # rows of the map reach the mirror as copies
    e, s = p.keyframe_clouds(3)
    p.carve(3, np.zeros(EC, bool), np.ones(SC_, bool))  # the clouds read before do not alias
    assert e.mask.any() and not p.edge_mask[3].any()
    np.testing.assert_array_equal(p._mirror_sync()["emk"][3].numpy(), p.edge_mask[3])


def test_load_copies_the_payload_unless_resumed_in_place(tmp_path):
    d = str(tmp_path / "payload")
    p = pdb.KeyframeDatabase(**KW, storage_dir=d, device="cpu")
    fill_into(None, p, 5)
    path = str(tmp_path / "ck.npz")
    p.save(path)
    before = {n: open(os.path.join(d, n + ".dat"), "rb").read() for n in PAYLOAD}
    npz_before = open(path, "rb").read()

    # a new session copies the payload: the checkpoint stays as it was
    session = str(tmp_path / "session2")
    q = pdb.KeyframeDatabase.load(path, storage_dir=session, device="cpu")
    fill_into(None, q, 9, start=5)
    q.carve(1, np.zeros(EC, bool), np.zeros(SC_, bool))
    for name in PAYLOAD:
        getattr(q, name).flush()
        assert getattr(q, name).filename.startswith(session)
        assert open(os.path.join(d, name + ".dat"), "rb").read() == before[name], name
    assert open(path, "rb").read() == npz_before
    assert q.n_keyframes == 9 and p.n_keyframes == 5

    # storage_dir equal to the payload directory resumes in place
    del p
    r = pdb.KeyframeDatabase.load(path, storage_dir=d, device="cpu")
    assert r.edge_xyz.filename.startswith(d) and r.n_keyframes == 5
    r.carve(0, np.zeros(EC, bool), np.ones(SC_, bool))
    r.edge_mask.flush()
    assert open(os.path.join(d, "edge_mask.dat"), "rb").read() != before["edge_mask"]

    # a payload moved with its checkpoint is found beside it
    moved = tmp_path / "moved"
    moved.mkdir()
    for name in PAYLOAD:
        os.replace(os.path.join(session, name + ".dat"), str(moved / (name + ".dat")))
    q.storage_dir = str(tmp_path / "gone")  # recorded, but no such directory at load
    q.save(str(moved / "ck.npz"))
    again = pdb.KeyframeDatabase.load(str(moved / "ck.npz"), device="cpu")
    assert again.n_keyframes == 9 and again.storage_dir == str(moved / "ck_session")


def test_a_payload_shorter_than_the_graph_is_refused(tmp_path):
    d = str(tmp_path / "payload")
    p = pdb.KeyframeDatabase(**KW, storage_dir=d, device="cpu")
    fill_into(None, p, 5)
    path = str(tmp_path / "ck.npz")
    p.save(path)
    del p
    with open(os.path.join(d, "sc.dat"), "r+b") as f:
        f.truncate(3 * 20 * 60 * 4)
    for load in (pdb.KeyframeDatabase.load, jdb.KeyframeDatabase.load):
        with pytest.raises(ValueError, match="holds 3 rows < 5 keyframes"):
            load(path, storage_dir=str(tmp_path / "s"))


def test_older_checkpoints_without_optional_keys_load(tmp_path):
    """``gnss_*``, ``eloop`` and ``storage`` are optional in a checkpoint."""
    p = pdb.KeyframeDatabase(**KW, device="cpu")
    fill_into(None, p, 4)
    path, old = str(tmp_path / "new.npz"), str(tmp_path / "old.npz")
    p.save(path)
    with np.load(path) as z:
        np.savez_compressed(old, **{k: z[k] for k in z.files
                                    if k not in ("gnss_pos", "gnss_valid", "eloop", "storage")})
    q, jq = pdb.KeyframeDatabase.load(old, device="cpu"), jdb.KeyframeDatabase.load(old)
    assert_same_database(jq, q)
    assert not q.gnss_valid.any() and not q.eloop.any() and q.n_edges == 3


def test_loaded_backend_relocalizes_where_the_reference_does(tmp_path):
    """The mapped course of ``tests/test_torch_lifelong.py`` saved by the
    reference, loaded by both packages (the port on the CPU, through the
    backend's and the system's ``load``): boot in RELOCALIZATION, the same
    matched keyframe, then the same decisions over four keyframes."""
    from tests.test_torch_lifelong import (
        LIFELONG, LOOP, drifted_odometry, loop_course, reference_features,
    )
    import jax

    traj, scans = loop_course()
    odom = drifted_odometry(traj)
    feats = [jax.tree.map(np.asarray, reference_features(*map(jnp.asarray, s))) for s in scans]
    jb, _ = make_backends()
    for i, (e, s) in enumerate(feats):
        jb.add_keyframe(0.1 * i, e, s, odom[i])
    path = str(tmp_path / "course.npz")
    jb.save(path)

    from lmsf_slam_tpu.backend import loop_closure as jlc
    from lmsf_slam_tpu_torch.backend import loop_closure as plc

    j2 = jll.LifelongBackend.load(path, config=jll.LifelongConfig(**LIFELONG),
                                  loop_config=jlc.LoopConfig(**LOOP))
    p2 = pll.LifelongBackend.load(path, device="cpu", config=pll.LifelongConfig(**LIFELONG),
                                  loop_config=plc.LoopConfig(**LOOP))
    assert p2.db.device.type == "cpu"
    assert p2.mode is pll.WorkMode.RELOCALIZATION and j2.mode is jll.WorkMode.RELOCALIZATION
    assert_same_database(j2.db, p2.db)
    start = 15
    for i in range(start, start + 4):
        o = np.asarray(se3np.pose_between(traj[start], traj[i]), np.float32)
        e, s = feats[i]
        a = j2.add_keyframe(100.0 + i, e, s, o)
        b = p2.add_keyframe(100.0 + i, to_port(e), to_port(s), o)
        np.testing.assert_allclose(b.map_pose, a.map_pose, atol=5e-2)
        assert np.linalg.norm(b.map_pose[4:] - traj[i, 4:]) < 0.3
    assert_same_decisions(j2.history, p2.history)
    assert p2.history[0].mode is pll.WorkMode.LOCALIZATION  # relocalized on the first keyframe

    # the port saves what it loaded; both packages read it back equal
    again = str(tmp_path / "again.npz")
    p2.save(again)
    assert_same_database(jdb.KeyframeDatabase.load(again), p2.db)

    # the system's load puts the frame and the database on the device named
    from lmsf_slam_tpu_torch.system import FeatureParams, SystemConfig

    cfg = SystemConfig(feature=FeatureParams(rings=16, width=360, edges_per_sector=2,
                                             surfs_per_sector=8), tracker_window=4)
    system = MultiLidarSystem.load(path, cfg, device="cpu")
    assert system.backend.db.device.type == "cpu" and system.device.type == "cpu"
    assert system.backend.mode is pll.WorkMode.RELOCALIZATION
    assert system.keyframe_trajectory().shape == (jb.db.n_keyframes, 7)


@pytest.mark.parametrize("full", [True, False], ids=["full", "windowed"])
def test_city_graph_solves_as_in_the_reference(full):
    """The pose graph of the city database (255 keyframes, 259 edges, 5 of
    them loop edges) through ``optimize`` in both packages: the inputs are
    equal bit for bit, so the GN iterations are equal, chi2 before and after
    to rtol 2e-3 and the poses to 1e-3 (measured 1.5e-4). Both packages run
    this graph to the cap of ``gn_iters`` while chi2 stays where it was: at
    coordinates of ~100 m a float32 step never falls under ``converged_dx``
    = 1e-5, in the reference as in the port."""
    cfg = dict(optimize_window=100, schur_submaps=0)
    jb = jll.LifelongBackend(db=jdb.KeyframeDatabase.load(CITY_DB),
                             config=jll.LifelongConfig(**cfg))
    pb = pll.LifelongBackend(db=pdb.KeyframeDatabase.load(CITY_DB, device="cpu"),
                             config=pll.LifelongConfig(**cfg))
    sj, sp = jb.optimize(full=full), pb.optimize(full=full)
    assert pb.solver_runs == jb.solver_runs
    log = pb.solve_log[-1]
    assert log["kind"] == ("full_replicated" if full else "windowed")
    assert log["iterations"] == int(sp.iterations) == int(sj.iterations)
    assert log["iterations"] == pb.config.pose_graph.gn_iters
    np.testing.assert_allclose(log["chi2_initial"], float(sj.chi2_initial), rtol=2e-3)
    np.testing.assert_allclose(log["chi2_final"], float(sj.chi2_final), rtol=2e-3)
    assert abs(log["chi2_final"] - log["chi2_initial"]) < 1e-2 * log["chi2_initial"]
    n = pb.db.n_keyframes
    np.testing.assert_allclose(pb.db.map_poses[:n], jb.db.map_poses[:n], atol=1e-3)
