"""The port's k-NN (``lmsf_slam_tpu_torch.ops.knn`` / ``neighbors``) against
the reference's ``neighbors.knn`` and its Pallas kernel ``knn_pallas``
(interpret mode), on the same numpy inputs, on the CPU — the three cases of
``tests/test_pallas_knn.py`` with its tolerances: distances rtol/atol 1e-5,
indices equal wherever distances are distinct.

On the CPU the port's ``knn`` takes its plain version (``knn_plain``); the
CUDA kernels themselves are held against that plain version on the card by
``tests/test_torch_knn_cuda.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.ops import neighbors as jn
from lmsf_slam_tpu.ops.pallas_knn import knn_pallas
from lmsf_slam_tpu_torch import _build
from lmsf_slam_tpu_torch.ops import knn as pk
from lmsf_slam_tpu_torch.ops import neighbors as pn


def _case(Q=100, N=700, q_invalid=7, r_invalid=13, seed=0):
    rng = np.random.default_rng(100 + seed)
    q = (rng.normal(size=(Q, 3)) * 15.0).astype(np.float32)
    r = (rng.normal(size=(N, 3)) * 15.0).astype(np.float32)
    return q, np.arange(Q) >= q_invalid, r, np.arange(N) >= r_invalid


def _reference(which, q, qm, r, rm, k):
    args = [jnp.asarray(a) for a in (q, qm, r, rm)]
    if which == "xla":
        d, i = jn.knn(*args, k=k)
    else:
        d, i = knn_pallas(*args, k=k, tq=32, tn=128, interpret=True)
    return np.asarray(d), np.asarray(i)


def _port(q, qm, r, rm, k):
    d, i = pn.knn(*(torch.as_tensor(a) for a in (q, qm, r, rm)), k=k)
    return d.numpy(), i.numpy()


REFS = ["xla", "pallas"]


@pytest.mark.parametrize("which", REFS)
def test_matches_exact_reference(which):
    q, qm, r, rm = _case()
    d_ref, i_ref = _reference(which, q, qm, r, rm, 5)
    d_p, i_p = _port(q, qm, r, rm, 5)
    np.testing.assert_allclose(d_p, d_ref, rtol=1e-5, atol=1e-5)
    distinct = np.diff(d_ref, axis=1, prepend=-1) > 1e-9
    keep = distinct & (d_ref < 1e30)
    np.testing.assert_array_equal(i_p[keep], i_ref[keep])
    assert i_p.dtype == np.int32


@pytest.mark.parametrize("which", REFS)
def test_invalid_handling(which):
    q, qm, r, rm = _case(Q=40, N=300, q_invalid=5, r_invalid=295)
    # only 5 valid reference points < k=8 → padded slots must be INF
    d_p, _ = _port(q, qm, r, rm, 8)
    assert np.all(d_p[:5] >= pk.INF * 0.9)  # invalid queries
    assert np.all(d_p[5:, :5] < 1e6)
    assert np.all(d_p[5:, 5:] >= pk.INF * 0.9)
    d_ref, _ = _reference(which, q, qm, r, rm, 8)
    np.testing.assert_allclose(d_p, d_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", REFS)
def test_nonmultiple_shapes(which):
    q, qm, r, rm = _case(Q=77, N=333, q_invalid=0, r_invalid=0, seed=3)
    d_ref, _ = _reference(which, q, qm, r, rm, 5)
    d_p, _ = _port(q, qm, r, rm, 5)
    np.testing.assert_allclose(d_p, d_ref, rtol=1e-5, atol=1e-5)


def test_nn1_radius_count_gather_match_reference():
    q, qm, r, rm = _case(Q=64, N=500, q_invalid=4, r_invalid=9, seed=5)
    jargs = [jnp.asarray(a) for a in (q, qm, r, rm)]
    pargs = [torch.as_tensor(a) for a in (q, qm, r, rm)]
    dj, ij = (np.asarray(a) for a in jn.nn1(*jargs))
    dp, ip = (a.numpy() for a in pn.nn1(*pargs))
    np.testing.assert_allclose(dp, dj, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ip[dj < 1e30], ij[dj < 1e30])
    np.testing.assert_array_equal(
        pn.radius_count(*pargs, 6.0).numpy(), np.asarray(jn.radius_count(*jargs, 6.0))
    )
    d5, i5 = pn.knn(*pargs, k=5)
    nbr, valid = pn.gather_neighbors(pargs[2], i5, d5)
    jd, ji = jn.knn(*jargs, k=5)
    jnbr, jvalid = jn.gather_neighbors(jargs[2], ji, jd)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(nbr.numpy()[valid.numpy()], np.asarray(jnbr)[np.asarray(jvalid)])


def test_kernel_wrapper_refuses_cpu_and_bad_k():
    """The kernel path takes CUDA tensors only and k in 1..8; it never
    falls back (on a CPU tensor it raises before building anything)."""
    q, qm, r, rm = (torch.as_tensor(a) for a in _case(Q=8, N=16))
    with pytest.raises(ValueError, match="CUDA"):
        pk.knn_cuda(q, qm, r, rm, 5)
    assert "knn" not in _build._libs  # nothing was built or loaded
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="k"):
            pk.knn_cuda(q.cuda(), qm.cuda(), r.cuda(), rm.cuda(), 9)

