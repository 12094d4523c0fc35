"""The k-NN CUDA kernels (``lmsf_slam_tpu_torch/csrc/knn.cu``) against the
plain torch version of the whole function, ``knn_plain``, on the card: at the
slice's shapes and at the corner cases of the split-and-merge design.

Marked ``cuda``: it skips without a card. This file imports no JAX, so it
also runs on a machine that has PyTorch and CUDA but no JAX:

    python -m pytest tests/test_torch_knn_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest configures JAX.)
"""
import pytest
import torch

from lmsf_slam_tpu_torch.ops import knn as pk

CASES = [
    # id, Q, N, k, masked queries, valid refs (fraction or count), duplicated refs, forced S
    ("edge", 384, 8192, 5, 3, 0.8, False, None),
    ("surf", 1536, 16384, 5, 3, 0.8, False, None),
    ("nn1", 1920, 24576, 1, 3, 0.8, False, None),
    ("non_multiple", 77, 333, 5, 3, 0.8, False, None),
    ("ties", 300, 4096, 8, 3, 0.8, True, 5),
    ("one_query", 1, 5000, 5, 0, 0.8, False, None),
    ("one_reference", 50, 1, 1, 2, 1.0, False, None),
    ("no_valid_reference", 64, 1000, 5, 0, 0, False, 2),
    ("ragged_split", 200, 5000, 5, 0, 0.8, False, 3),
    ("k_above_valid_split", 40, 3000, 8, 5, 5, False, 6),
]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,N,k,q_invalid,r_valid,dup,splits",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_kernel_matches_plain_on_card(Q, N, k, q_invalid, r_valid, dup, splits):
    """``knn_cuda`` against ``knn_plain`` on the card (see
    chip_smoke.compare_knn for the tolerances and the near-tie rule: the plain
    version picks candidates by the expansion form, which cannot separate
    distances closer than its float32 rounding). The small cases must also
    equal the single-scan model bit for bit, ties included, and the result
    must not change with the lanes a query."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the k-NN kernels run only on one")
    import chip_smoke

    q, qm, r, rm = chip_smoke.knn_case(Q, N, q_invalid, r_valid, seed=Q + N + k,
                                       dev=torch.device("cuda"), dup=dup)
    chip_smoke.compare_knn(pk, q, qm, r, rm, k, exact_model=N <= 5000, dup=dup,
                           splits=splits)  # raises on any disagreement
    d8, i8, _ = pk.knn_cuda(q, qm, r, rm, k, splits=splits, lanes=8)
    d4, i4, nbr = pk.knn_cuda(q, qm, r, rm, k, splits=2 if N >= 32 else 1, lanes=4,
                              neighbors=True)
    assert torch.equal(d8, d4) and torch.equal(i8, i4)
    assert torch.equal(nbr, r[i4.long()])


@pytest.mark.cuda
def test_reference_views_off_16_byte_alignment():
    """The scan copies 16-byte chunks; a contiguous view that starts off that
    alignment must give the same result as its aligned copy."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the k-NN kernels run only on one")
    import chip_smoke

    q, qm, r, rm = chip_smoke.knn_case(200, 3001, 3, 0.8, seed=5, dev=torch.device("cuda"))
    r_view, rm_view = r[1:], rm[1:]
    assert r_view.data_ptr() % 16 and rm_view.data_ptr() % 16 and r_view.is_contiguous()
    d, i, nbr = pk.knn_cuda(q, qm, r_view, rm_view, 5, splits=3, neighbors=True)
    d2, i2, nbr2 = pk.knn_cuda(q, qm, r_view.clone(), rm_view.clone(), 5, splits=3, neighbors=True)
    assert torch.equal(d, d2) and torch.equal(i, i2) and torch.equal(nbr, nbr2)
    chip_smoke.compare_knn(pk, q, qm, r_view, rm_view, 5, exact_model=True)
