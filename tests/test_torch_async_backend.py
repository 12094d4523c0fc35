"""The port's worker-thread backend
(``lmsf_slam_tpu_torch.backend.async_backend.AsyncBackend``) against the
reference's (``lmsf_slam_tpu/backend/async_backend.py``), on the CPU.

Queue semantics: both classes wrap a stub backend whose ``add_keyframe``
waits on an event, so the worker holds exactly one item while the queue
fills; the same submit sequence must then give the same ``enqueued`` flags,
``dropped`` and ``coalesced`` counts and the same surviving items, in order,
under all three policies (and the legacy ``drop_when_full`` switch). These
are integers and must be equal.

On the real backend: the cases of ``tests/test_async_backend.py`` through the
port; the ``block`` policy followed by ``flush`` must leave the database and
the history equal to the sync backend's bit for bit (one thread at a time
runs the same arithmetic in the same order); a worker that raises surfaces
as ``RuntimeError`` on the caller's thread at the next ``submit`` or
``flush``. Every wait in this file has a timeout of its own, so a deadlock
fails the test instead of hanging it.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lmsf_slam_tpu.backend import async_backend as jab
from lmsf_slam_tpu.backend import lifelong as jll
from lmsf_slam_tpu_torch.backend import AsyncBackend
from lmsf_slam_tpu_torch.backend import async_backend as pab
from lmsf_slam_tpu_torch.backend import keyframe_db as pdb
from lmsf_slam_tpu_torch.backend import lifelong as pll
from lmsf_slam_tpu_torch.backend import loop_closure as plc
from lmsf_slam_tpu_torch.utils.profiling import StageTimer
from tests.test_torch_lifelong import (
    DB, LIFELONG, LOOP, drifted_odometry, loop_course, reference_features,
)
from tests.test_torch_registration import to_port
from tests import torch_threads  # noqa: F401

WAIT = 20.0  # s, the longest any single wait below may take
IDENT = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)


def within(seconds, fn, *args, **kw):
    """Run ``fn`` on a thread and fail if it has not returned in time."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args, **kw)
        except BaseException as exc:  # noqa: BLE001 - handed to the caller
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"{getattr(fn, '__name__', fn)} did not return in {seconds} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


class StubBackend:
    """A backend that records what reaches it. ``add_keyframe`` waits for
    ``gate``; ``entered`` is set when the worker holds its first item."""

    def __init__(self, work_mode, mode_name, fail_on=()):
        self.WorkMode = work_mode
        self.mode = work_mode[mode_name]
        self.odom2map = IDENT.copy()
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.processed = []
        self.fail_on = set(fail_on)
        self.timer = StageTimer()  # the port's worker records its spans here

    def add_keyframe(self, stamp, edge, surf, odom_pose, gnss_pos=None, scan_grid=None):
        self.entered.set()
        assert self.gate.wait(WAIT), "the test never opened the gate"
        if stamp in self.fail_on:
            raise ValueError(f"keyframe {stamp} is poisoned")
        self.processed.append((stamp, None if gnss_pos is None else tuple(gnss_pos)))
        self.odom2map = np.array([1, 0, 0, 0, stamp, 0, 0], np.float32)
        return ("out", stamp)

    def force_global_optimize(self):
        return "optimized"

    def save(self, path):
        self.saved = path


def run_sequence(async_cls, work_mode, mode, n=9, gnss_at=(2, 5), **kw):
    """Submit ``n`` keyframes to a stalled worker (those at ``gnss_at`` carry
    a fix), then open the gate and flush. Under ``block`` the gate opens
    from a second thread once the submitter is blocked on a full queue."""
    stub = StubBackend(work_mode, mode)
    ab = async_cls(stub, max_queue=3, **kw)
    flags, published = [], []
    lossless = ab.policy == "block" or (ab.policy == "coalesce" and mode == "MAPPING")
    if lossless:
        threading.Timer(0.3, stub.gate.set).start()
    for i in range(n):
        gnss = np.array([i, 0.0, 0.0], np.float32) if i in gnss_at else None
        o2m, m, enq = within(WAIT, ab.submit, float(i), None, None, IDENT, gnss_pos=gnss)
        flags.append(enq)
        published.append(m.name)
        if i == 0:  # the worker takes item 0 off the queue before the rest arrive
            assert stub.entered.wait(WAIT)
    backlog = ab.backlog
    stub.gate.set()
    within(WAIT, ab.flush)
    out = dict(flags=flags, dropped=ab.dropped, coalesced=ab.coalesced, processed=stub.processed,
               outputs=ab.outputs(), backlog_before=backlog, backlog_after=ab.backlog,
               odom2map=ab.odom2map.tolist(), mode=ab.mode.name, published=published)
    within(WAIT, ab.close)
    return out


@pytest.mark.parametrize("mode", ["MAPPING", "LOCALIZATION", "RELOCALIZATION"])
@pytest.mark.parametrize("kw", [dict(policy="coalesce"), dict(policy="block"), dict(policy="drop"),
                                dict(drop_when_full=True), dict(drop_when_full=False), {}],
                         ids=["coalesce", "block", "drop", "legacy-drop", "legacy-block",
                              "default"])
def test_queue_semantics_equal_the_reference(kw, mode):
    want = run_sequence(jab.AsyncBackend, jll.WorkMode, mode, **kw)
    got = run_sequence(pab.AsyncBackend, pll.WorkMode, mode, **kw)
    lossless = kw.get("policy") == "block" or kw.get("drop_when_full") is False or (
        kw.get("policy", "coalesce") == "coalesce" and "drop_when_full" not in kw
        and mode == "MAPPING")
    if lossless:
        # the submitter waits for slots while the worker drains: everything is
        # processed, in order; the backlog at the end of the submits is timing
        want.pop("backlog_before"), got.pop("backlog_before")
        assert got["processed"] == [(float(i), (i, 0.0, 0.0) if i in (2, 5) else None)
                                    for i in range(9)]
    assert got == want
    assert got["backlog_after"] == 0
    assert len(got["processed"]) == 9 - got["dropped"] - got["coalesced"]
    if kw.get("policy") == "drop" or kw.get("drop_when_full"):
        # 1 in the worker's hands + 3 queued, the other 5 shed; flags say which
        assert got["dropped"] == 5 and got["flags"] == [True] * 4 + [False] * 5
    if kw.get("policy", "coalesce") == "coalesce" and "drop_when_full" not in kw and (
            mode != "MAPPING"):
        # refreshes are superseded, never the items that carry a fix
        assert got["coalesced"] == 5 and got["dropped"] == 0 and all(got["flags"])
        stamps = [s for s, _ in got["processed"]]
        assert 2.0 in stamps and 5.0 in stamps and stamps[-1] == 8.0


def test_constructor_rejects_an_unknown_policy():
    with pytest.raises(ValueError, match="unknown async policy"):
        AsyncBackend(StubBackend(pll.WorkMode, "MAPPING"), policy="shed")


@pytest.mark.parametrize("surface_at", ["flush", "submit", "force_global_optimize", "save"])
def test_a_raising_worker_surfaces_on_the_callers_thread(surface_at):
    stub = StubBackend(pll.WorkMode, "MAPPING", fail_on={1.0})
    ab = AsyncBackend(stub, max_queue=3, policy="block")
    for i in range(3):  # all queued behind the stalled worker, then it runs
        within(WAIT, ab.submit, float(i), None, None, IDENT)
    stub.gate.set()
    deadline = time.monotonic() + WAIT
    while ab.backlog and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ab.backlog == 0  # the worker kept draining past the failure
    call = {"flush": ab.flush, "force_global_optimize": ab.force_global_optimize,
            "submit": lambda: ab.submit(3.0, None, None, IDENT),
            "save": lambda: ab.save("unused.npz")}[surface_at]
    with pytest.raises(RuntimeError, match="async backend worker failed") as err:
        within(WAIT, call)
    assert isinstance(err.value.__cause__, ValueError)
    assert [s for s, _ in stub.processed] == [0.0, 2.0]
    within(WAIT, ab.flush)  # raised once; the facade stays usable
    assert within(WAIT, ab.force_global_optimize) == "optimized"
    within(WAIT, ab.close)
    assert not ab._worker.is_alive()


def test_a_worker_that_dies_while_the_queue_is_full_does_not_deadlock_submit():
    stub = StubBackend(pll.WorkMode, "MAPPING", fail_on={0.0, 1.0, 2.0, 3.0})
    ab = AsyncBackend(stub, max_queue=1, policy="block")
    within(WAIT, ab.submit, 0.0, None, None, IDENT)
    assert stub.entered.wait(WAIT)
    within(WAIT, ab.submit, 1.0, None, None, IDENT)  # fills the queue
    threading.Timer(0.2, stub.gate.set).start()
    with pytest.raises(RuntimeError, match="async backend worker failed"):
        within(WAIT, ab.submit, 2.0, None, None, IDENT)  # blocked, then sees the failure
        within(WAIT, ab.submit, 3.0, None, None, IDENT)
        within(WAIT, ab.flush)
    stub.fail_on.clear()
    try:
        within(WAIT, ab.flush)
    except RuntimeError:
        pass  # a second failure recorded after the first was raised
    within(WAIT, ab.close)


def test_worker_thread_sets_its_own_grad_mode():
    import torch

    seen = {}

    class Probe(StubBackend):
        def add_keyframe(self, stamp, *a, **k):
            seen[stamp] = torch.is_grad_enabled()
            return super().add_keyframe(stamp, *a, **k)

    for stamp, ctx in ((0.0, torch.no_grad()), (1.0, torch.enable_grad())):
        stub = Probe(pll.WorkMode, "MAPPING")
        stub.gate.set()
        with ctx:
            ab = AsyncBackend(stub)
        within(WAIT, ab.submit, stamp, None, None, IDENT)
        within(WAIT, ab.close)
    assert seen == {0.0: False, 1.0: True}  # the mode the facade was made under


def test_two_threads_reaching_a_kernels_first_launch_build_it_once(monkeypatch, tmp_path):
    """The frontend and the worker may both reach the first k-NN launch: the
    build and the handle cache sit behind one lock, so the kernel is built
    once and every thread gets the same handle. (No compiler here: the build
    and the loader are stand-ins that record their calls.)"""
    from lmsf_slam_tpu_torch import _build

    calls = {"build": 0, "dlopen": 0}

    def fake_build(names):
        calls["build"] += 1
        time.sleep(0.2)  # a second thread arrives while the first still builds

    def fake_cdll(path):
        calls["dlopen"] += 1
        return object()

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_lib_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "launches", {})
    handles = []
    threads = [threading.Thread(target=lambda: handles.append(_build.load("fake")))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"build": 1, "dlopen": 1}
    assert len(handles) == 4 and all(h is handles[0] for h in handles)
    assert _build.launches == {"fake": 0}
    counters = [threading.Thread(target=lambda: [_build.count_launch("fake") for _ in range(500)])
                for _ in range(4)]
    for t in counters:
        t.start()
    for t in counters:
        t.join(WAIT)
    assert _build.launches["fake"] == 2000
    _build.reset_launches()
    assert _build.launches["fake"] == 0


# ---------------------------------------------------------------------------
# on the real backend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def course():
    traj, scans = loop_course()
    feats = [jax.tree.map(np.asarray, reference_features(*map(jnp.asarray, s))) for s in scans]
    return traj, drifted_odometry(traj), [(to_port(e), to_port(s)) for e, s in feats]


def port_backend(**lifelong):
    return pll.LifelongBackend(
        db=pdb.KeyframeDatabase(**DB, device="cpu"),
        config=pll.LifelongConfig(**{**LIFELONG, **lifelong}), loop_config=plc.LoopConfig(**LOOP))


def test_block_policy_and_flush_equal_the_sync_backend_bit_for_bit(course):
    _, odom, feats = course
    sync = port_backend()
    ab = AsyncBackend(port_backend(), max_queue=2, policy="block")
    for i, (e, s) in enumerate(feats):
        sync.add_keyframe(0.1 * i, e, s, odom[i])
        _, _, enq = within(120.0, ab.submit, 0.1 * i, e, s, odom[i])
        assert enq
    within(300.0, ab.flush)
    a, b = sync, ab.backend
    assert (ab.dropped, ab.coalesced, ab.backlog) == (0, 0, 0)
    assert sum(h.loop_closed for h in b.history) >= 1  # the worker closed the loop
    assert ab.mode is pll.WorkMode.LOCALIZATION and ab.mode is a.mode
    assert len(ab.outputs()) == len(feats) == len(a.history)
    for x, y in zip(a.history, ab.outputs()):
        assert (x.mode, x.keyframe_id, x.loop_closed) == (y.mode, y.keyframe_id, y.loop_closed)
        np.testing.assert_array_equal(x.map_pose, y.map_pose)
        np.testing.assert_array_equal(x.odom2map, y.odom2map)
        assert (x.score == y.score or (np.isnan(x.score) and np.isnan(y.score)))
    n, e_ = a.db.n_keyframes, a.db.n_edges
    assert (b.db.n_keyframes, b.db.n_edges) == (n, e_)
    for name in ("map_poses", "odom_poses", "edge_xyz", "surf_mask", "sc", "ring_keys"):
        np.testing.assert_array_equal(getattr(b.db, name)[:n], getattr(a.db, name)[:n], name)
    for name in ("eij", "ez", "esqrtw", "eloop"):
        np.testing.assert_array_equal(getattr(b.db, name)[:e_], getattr(a.db, name)[:e_], name)
    np.testing.assert_array_equal(ab.odom2map, a.odom2map)
    assert b.solver_runs == a.solver_runs and [s["iterations"] for s in b.solve_log] == [
        s["iterations"] for s in a.solve_log]
    assert ab.db is b.db
    within(WAIT, ab.close)


def test_async_flush_and_save(course, tmp_path):
    """GNSS observations ride the queue with the keyframe; ``save`` flushes."""
    traj, odom, feats = course
    ab = AsyncBackend(port_backend(optimize_batch=100))
    for i in range(10):
        gnss = traj[i, 4:].astype(np.float32) if i % 3 == 0 else None
        within(WAIT, ab.submit, 0.1 * i, *feats[i], odom[i], gnss_pos=gnss)
    path = str(tmp_path / "async.npz")
    within(120.0, ab.save, path)  # implies flush
    assert ab.db.n_keyframes == 10 and ab.backlog == 0
    assert ab.db.gnss_valid[:10].sum() == 4  # i = 0, 3, 6, 9
    loaded = pll.LifelongBackend.load(path, device="cpu")
    assert loaded.db.n_keyframes == 10 and loaded.db.gnss_valid[:10].sum() == 4
    assert loaded.mode is pll.WorkMode.RELOCALIZATION
    assert within(120.0, ab.force_global_optimize) is not None
    within(WAIT, ab.close)


def test_async_worker_error_surfaces_no_deadlock():
    ab = AsyncBackend(port_backend())
    # poison: edge/surf of the wrong type blows up inside add_keyframe
    within(WAIT, ab.submit, 0.0, None, None, IDENT)
    with pytest.raises(RuntimeError, match="async backend worker failed"):
        within(WAIT, ab.flush)
    within(WAIT, ab.close)  # the queue drained; the facade stays usable for shutdown


@pytest.mark.parametrize("policy,mode", [("drop", "MAPPING"), ("coalesce", "LOCALIZATION"),
                                         ("coalesce", "MAPPING")])
def test_backpressure_on_the_real_backend(course, policy, mode):
    """The cases of ``tests/test_async_backend.py``: a stalled worker and a
    queue of 2. ``drop`` sheds and counts; ``coalesce`` while localizing
    supersedes refreshes but never the one that carries a fix; ``coalesce``
    while mapping stores every keyframe."""
    _, odom, feats = course
    backend = port_backend()
    if mode == "LOCALIZATION":
        for i in range(6):  # a small map to localize in
            backend.add_keyframe(0.1 * i, *feats[i], odom[i])
        backend.mode = pll.WorkMode.LOCALIZATION
    n0 = backend.db.n_keyframes
    ab = AsyncBackend(backend, max_queue=2, policy=policy)
    gate, orig, processed = threading.Event(), backend.add_keyframe, []

    def slow_add(stamp, *a, **k):
        assert gate.wait(WAIT)
        processed.append(round(stamp, 3))
        return orig(stamp, *a, **k)

    backend.add_keyframe = slow_add
    if policy == "coalesce" and mode == "MAPPING":
        threading.Timer(0.2, gate.set).start()  # lossless: the submitter waits for the worker
    t_max = 0.0
    for i in range(8):
        gnss = odom[i, 4:] if i == 2 else None
        t0 = time.perf_counter()
        _, _, enq = within(WAIT, ab.submit, 1.0 + 0.1 * i, *feats[6 + i], odom[6 + i],
                           gnss_pos=gnss)
        t_max = max(t_max, time.perf_counter() - t0)
        assert enq or policy == "drop"
    gate.set()
    within(120.0, ab.flush)
    assert len(processed) == 8 - ab.dropped - ab.coalesced
    if policy == "drop":
        assert ab.dropped > 0 and ab.coalesced == 0
        assert ab.db.n_keyframes + ab.dropped == 8
    elif mode == "LOCALIZATION":
        assert ab.coalesced > 0 and ab.dropped == 0
        assert 1.2 in processed  # the keyframe with the fix was never the victim
        assert t_max < 0.5  # and the frontend never blocked on the stalled worker
    else:
        assert (ab.dropped, ab.coalesced) == (0, 0) and ab.db.n_keyframes == n0 + 8
    within(WAIT, ab.close)
