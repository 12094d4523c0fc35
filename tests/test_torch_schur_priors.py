"""The port's Schur solve with unary factors (GNSS position, plane and
orientation priors) against the reference's, on the CPU: the prior case of
``tests/test_schur.py``, beside its own file so that each file stays short.
Tolerances as in ``tests/test_torch_schur.py``.
"""
import numpy as np

from tests.test_torch_schur import assert_same, chain_graph, geo_err, replicated, schur_both


def test_schur_unary_priors_match_replicated():
    """GNSS xyz + plane priors through the Schur path reach the reference's
    Schur solution and the replicated solver's anchored optimum (fixed =
    all-False: the priors give the gauge)."""
    poses, eij, ez, gt = chain_graph(n=48, n_loops=0, noise=0.02, seed=9)
    V, E = poses.shape[0], eij.shape[0]
    sqrtw = np.full((E, 6), 10.0, np.float32)
    emask = np.ones(E, bool)
    ids = np.arange(0, V, 8, dtype=np.int32)
    K = 8
    pidx, pmask = np.zeros(K, np.int32), np.zeros(K, bool)
    pxyz = np.zeros((K, 3), np.float32)
    pidx[: ids.size], pmask[: ids.size] = ids, True
    pxyz[: ids.size] = gt[ids, 4:]
    priors = dict(prior_xyz=pxyz, prior_idx=pidx, prior_sqrtw=np.full((K, 3), 10.0, np.float32),
                  prior_mask=pmask, plane_idx=pidx, plane_z=np.zeros(K, np.float32),
                  plane_sqrtw=np.full((K, 3), 5.0, np.float32), plane_mask=pmask)
    params = dict(gn_iters=40, kernel="none", converged_dx=1e-7)
    po, ps, jo, js = schur_both(poses, eij, ez, sqrtw, emask, params, n_submaps=4,
                                fixed=np.zeros(V, bool), **priors)
    assert_same(po, ps, jo, js)
    ref, ref_stats = replicated(poses, eij, ez, sqrtw, emask, dict(params, pcg_iters=256),
                                fixed=np.zeros(V, bool), **priors)
    assert float(ps.chi2_final) <= float(ref_stats.chi2_final) * 1.05 + 1e-3
    assert geo_err(ref.numpy(), po) < 5e-3
    # the priors anchor: anchored vertices end near their GNSS fixes
    assert np.linalg.norm(po[ids, 4:] - pxyz[: ids.size], axis=1).max() < 0.15


def test_orientation_priors_and_nan_factor_match_reference():
    """The orientation-prior group through both packages' Schur solves; and a
    graph whose interior system is not positive definite (a NaN edge) gives
    NaN poses in both, with no host check raising in the port."""
    poses, eij, ez, gt = chain_graph(n=32, n_loops=3, noise=0.02, seed=4)
    V, E = poses.shape[0], eij.shape[0]
    sqrtw = np.full((E, 6), 10.0, np.float32)
    emask = np.ones(E, bool)
    ids = np.array([3, 11, 17, 30, 0, 0, 0, 0], np.int32)
    qmask = np.arange(8) < 4
    quat = np.zeros((8, 4), np.float32)
    quat[:, 0] = 1
    quat[:4] = gt[ids[:4], :4]
    # four iterations: both stop at the cap (the exit test at 1e-5 sits in
    # float32 rounding at the fifth)
    params = dict(gn_iters=4, kernel="huber")
    po, ps, jo, js = schur_both(
        poses, eij, ez, sqrtw, emask, params, n_submaps=4, qprior_quat=quat,
        qprior_idx=ids, qprior_sqrtw=np.full((8, 3), 20.0, np.float32), qprior_mask=qmask)
    assert_same(po, ps, jo, js)
    bad = ez.copy()
    bad[5, 4] = np.nan
    po, _, jo, _ = schur_both(poses, eij, bad, sqrtw, emask, dict(gn_iters=2), n_submaps=4)
    assert np.isnan(jo[1:]).any() and np.isnan(po[1:]).any()
    np.testing.assert_array_equal(np.isnan(po), np.isnan(jo))
