"""The city database's pose graph (``eval_out_city/city_db.npz``: 255
keyframes, 259 edges, 5 of them loop edges) through
``LifelongBackend.optimize(full=True)`` on the Schur path, in both packages,
on the CPU: ``schur_submaps=16, schur_min_vertices=192``, as
``scripts/evaluate.py`` configures the city runs.

The inputs are equal bit for bit, so both packages run the same number of GN
iterations (the 12-iteration cap: at coordinates of ~100 m a float32 step
never falls under ``converged_dx``, in either package); chi2 before and after
agree to rtol 1e-4. The poses agree to 5e-4 (m and rad; measured 1.07e-4):
a float32 ulp at 100 m is 7.6e-6 m, and 12 iterations carry each package's
rounding forward (the replicated solve's city test allows 1e-3).
"""
import os

import numpy as np

from lmsf_slam_tpu.backend import keyframe_db as jdb
from lmsf_slam_tpu.backend import lifelong as jll
from lmsf_slam_tpu_torch.backend import keyframe_db as pdb
from lmsf_slam_tpu_torch.backend import lifelong as pll
from tests.test_torch_schur import geo_err
from tests import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CITY_DB = os.path.join(ROOT, "eval_out_city", "city_db.npz")


def test_city_graph_schur_solve_matches_reference():
    cfg = dict(optimize_window=100, schur_submaps=16, schur_min_vertices=192)
    jb = jll.LifelongBackend(db=jdb.KeyframeDatabase.load(CITY_DB),
                             config=jll.LifelongConfig(**cfg))
    pb = pll.LifelongBackend(db=pdb.KeyframeDatabase.load(CITY_DB, device="cpu"),
                             config=pll.LifelongConfig(**cfg))
    before = pb.db.map_poses[: pb.db.n_keyframes].copy()
    sj, sp = jb.optimize(full=True), pb.optimize(full=True)
    assert pb.solver_runs == jb.solver_runs == {"full_schur": 1, "full_replicated": 0,
                                                 "windowed": 0}
    log = pb.solve_log[-1]
    assert log["kind"] == "full_schur" and log["vertices"] == pb.db.n_keyframes == 255
    assert log["iterations"] == int(sp.iterations) == int(sj.iterations)
    np.testing.assert_allclose(log["chi2_initial"], float(sj.chi2_initial), rtol=1e-4)
    np.testing.assert_allclose(log["chi2_final"], float(sj.chi2_final), rtol=1e-4)
    n = pb.db.n_keyframes
    assert geo_err(pb.db.map_poses[:n], jb.db.map_poses[:n]) < 5e-4
    # the solve moved the poses (the graph is not at its optimum on disk)
    assert geo_err(pb.db.map_poses[:n], before) > 1e-4
