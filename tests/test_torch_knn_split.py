"""The decomposition of the port's k-NN kernels, on the CPU.

``knn_split_merge_plain`` is a plain torch model of what ``csrc/knn.cu`` does
(references cut into ``splits`` slices × ``lanes`` strides, a top-k of each
part, a merge ordered by ``(d, idx)``). It must equal ``knn_plain`` — the
version CPU tensors take — whatever the split, ties and empty parts
included, and ``choose_splits`` / ``slice_bounds`` must fill the card and
cover every reference exactly once. ``knn()`` on CPU tensors is held against
the JAX ``neighbors.knn`` and ``knn_pallas`` (interpret mode) on the same
numpy inputs.

Tolerances: distances rtol 1e-6 (the plain version sums the three squares
through ``torch.sum``, the model as ``(dx² + dy²) + dz²``: 2–3 float32 ulps);
indices equal wherever a distance is distinct from its neighbours by more than
1e-6 relative; exact equality, ties included, between two splits of the model.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmsf_slam_tpu_torch as port
from lmsf_slam_tpu.ops import neighbors as jn
from lmsf_slam_tpu.ops.pallas_knn import knn_pallas
from lmsf_slam_tpu_torch.ops import knn as pk

SPLITS = [1, 2, 3, 7]
LANES = [1, 4, 8]


def _cloud(Q, N, q_invalid=3, r_valid=0.8, seed=0, dup=False):
    rng = np.random.default_rng(700 + seed)
    q = (rng.normal(size=(Q, 3)) * 15.0).astype(np.float32)
    r = (rng.normal(size=(N, 3)) * 15.0).astype(np.float32)
    if dup:  # every point four times, interleaved over the whole index range
        base = r[: N // 4]
        r = np.concatenate([base, base, base, base])[rng.permutation(4 * (N // 4))]
    qm = np.arange(Q) >= q_invalid
    rm = rng.random(r.shape[0]) < r_valid
    return tuple(torch.as_tensor(a) for a in (q, qm, r, rm))


def _assert_agree(d, i, d_ref, i_ref):
    """Distances rtol 1e-6; indices equal where the reference distance is
    distinct from both neighbours (1e-6 relative) and finite."""
    d, i, d_ref, i_ref = (a.numpy() for a in (d, i, d_ref, i_ref))
    np.testing.assert_allclose(d, d_ref, rtol=1e-6, atol=0.0)
    gap = np.diff(d_ref, axis=1)
    big = np.full_like(d_ref[:, :1], np.inf)
    rel = 1e-6 * np.maximum(np.abs(d_ref), 1e-30)
    distinct = ((np.concatenate([big, gap], 1) > rel) & (np.concatenate([gap, big], 1) > rel)
                & (d_ref < 1e30))
    np.testing.assert_array_equal(i[distinct], i_ref[distinct])
    assert i.dtype == np.int32
    np.testing.assert_array_equal(i[d >= 1e30], 0)  # empty slots gather reference 0


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("splits", SPLITS)
def test_split_merge_equals_plain_on_random_clouds(splits, lanes):
    q, qm, r, rm = _cloud(90, 700, seed=splits * 10 + lanes)
    _assert_agree(*pk.knn_split_merge_plain(q, qm, r, rm, 5, splits, lanes),
                  *pk.knn_plain(q, qm, r, rm, 5))


@pytest.mark.parametrize("splits,lanes", [(2, 4), (3, 8), (7, 8), (7, 1)])
def test_split_merge_ties_go_to_the_lowest_index(splits, lanes):
    """Every reference point is present four times, spread over slices and
    lanes: any split must return the same indices as one ascending scan, and
    those are the lowest indices of each group of duplicates."""
    q, qm, r, rm = _cloud(60, 400, seed=1, dup=True)
    d1, i1 = pk.knn_split_merge_plain(q, qm, r, rm, 8, 1, 1)
    d, i = pk.knn_split_merge_plain(q, qm, r, rm, 8, splits, lanes)
    assert torch.equal(d, d1) and torch.equal(i, i1)
    # the single scan itself: a brute-force lexicographic order in numpy
    dn = pk.pair_distances(q, r).numpy().astype(np.float64)
    dn[:, ~rm.numpy()] = np.inf
    for row in (3, 17, 59):
        want = np.lexsort((np.arange(dn.shape[1]), dn[row]))[:8]
        np.testing.assert_array_equal(i1[row].numpy(), want)
    # duplicates are adjacent in the output and their indices ascend
    same = d1[:, 1:] == d1[:, :-1]
    assert same[3:].any()
    assert bool(((i1[:, 1:] > i1[:, :-1]) | ~same)[3:].all())


@pytest.mark.parametrize("splits,lanes", [(1, 1), (3, 4), (7, 8)])
def test_split_merge_k_above_valid_references(splits, lanes):
    """5 valid references < k = 8: slices and lanes without any valid point
    merge to INF / index 0 and never displace a real neighbour."""
    q, qm, r, _ = _cloud(40, 300, q_invalid=5, seed=2)
    rm = torch.zeros(300, dtype=torch.bool)
    rm[[0, 17, 150, 151, 299]] = True
    d, i = pk.knn_split_merge_plain(q, qm, r, rm, 8, splits, lanes)
    _assert_agree(d, i, *pk.knn_plain(q, qm, r, rm, 8))
    assert bool((d[5:, :5] < 1e6).all()) and bool((d[5:, 5:] >= pk.INF * 0.9).all())
    assert bool((d[:5] >= pk.INF * 0.9).all()) and bool((i[:5] == 0).all())
    assert set(i[5:, :5].flatten().tolist()) == {0, 17, 150, 151, 299}


@pytest.mark.parametrize("N,splits", [(333, 2), (333, 7), (1001, 3), (50, 7)])
def test_split_merge_ragged_slices(N, splits):
    q, qm, r, rm = _cloud(33, N, seed=N)
    _assert_agree(*pk.knn_split_merge_plain(q, qm, r, rm, 5, splits, 8),
                  *pk.knn_plain(q, qm, r, rm, 5))


@pytest.mark.parametrize("splits,lanes", [(1, 1), (3, 8)])
def test_split_merge_every_reference_invalid(splits, lanes):
    q, qm, r, _ = _cloud(20, 200, seed=4)
    rm = torch.zeros(200, dtype=torch.bool)
    d, i = pk.knn_split_merge_plain(q, qm, r, rm, 5, splits, lanes)
    assert bool((d >= pk.INF * 0.9).all()) and bool((i == 0).all())
    d_p, i_p = pk.knn_plain(q, qm, r, rm, 5)
    assert torch.equal(d, d_p) and torch.equal(i, i_p)


def test_merge_partials_plain_keeps_real_neighbours_before_empty_slots():
    part_d = torch.tensor([[[pk.INF, pk.INF], [2.0, pk.INF], [1.0, 2.0]]])
    part_i = torch.tensor([[[0, 0], [9, 0], [4, 7]]], dtype=torch.int32)
    d, i = pk.merge_partials_plain(part_d, part_i, torch.tensor([True]), 2)
    assert d.tolist() == [[1.0, 2.0]] and i.tolist() == [[4, 7]]  # (2, 7) before (2, 9)
    d, i = pk.merge_partials_plain(part_d[:, :2], part_i[:, :2], torch.tensor([True]), 2)
    assert d[0, 0] == 2.0 and d[0, 1] >= pk.INF * 0.9 and i.tolist() == [[9, 0]]
    d, i = pk.merge_partials_plain(part_d, part_i, torch.tensor([False]), 2)
    assert bool((d >= pk.INF * 0.9).all()) and i.tolist() == [[0, 0]]


@pytest.mark.parametrize("Q,N", [(384, 8192), (1536, 16384), (1920, 24576)])
def test_choose_splits_fills_the_card(Q, N):
    """At the frame's shapes the grid has at least two blocks for each of the
    H100's 132 SMs, and no slice is shorter than MIN_SLICE."""
    S = pk.choose_splits(Q, N)
    query_tiles = -(-Q // (pk.THREADS // pk.LANES))
    assert query_tiles * S >= 264
    assert S <= 65535 and pk.slice_length(N, S) >= pk.MIN_SLICE


@pytest.mark.parametrize("Q,N", [(384, 2688), (1536, 10752), (384, 3840), (1536, 15360),
                                 (384, 4224), (1536, 16896)])
def test_choose_splits_at_the_backend_local_maps(Q, N):
    """The backend's local maps (7, 10 and 11 keyframes of 384 edge or 1536
    surf points): several slices of MIN_SLICE..MAX_SLICE points that start
    16-point aligned and cover the map exactly once. (The edge shapes stay
    under 264 blocks: a slice is never cut below MIN_SLICE.)"""
    S = pk.choose_splits(Q, N)
    slice_len, bounds = pk.slice_length(N, S), pk.slice_bounds(N, S)
    assert S > 1 and pk.MIN_SLICE <= slice_len <= pk.MAX_SLICE and slice_len % pk.ALIGN == 0
    covered = np.concatenate([np.arange(b, e) for b, e in bounds])
    np.testing.assert_array_equal(covered, np.arange(N))
    assert -(-Q // (pk.THREADS // pk.LANES)) * S >= 120


@pytest.mark.parametrize("Q,N", [(77, 333), (1, 1), (40, 300), (1920, 255)])
def test_choose_splits_is_one_for_tiny_problems(Q, N):
    assert pk.choose_splits(Q, N) == 1


@pytest.mark.parametrize("N,splits", [(8192, 22), (16384, 8), (24576, 12), (333, 1), (333, 7),
                                      (1, 1), (40, 7), (1001, 3)])
def test_slices_cover_every_reference_exactly_once(N, splits):
    slice_len, bounds = pk.slice_length(N, splits), pk.slice_bounds(N, splits)
    assert len(bounds) == splits and slice_len % pk.ALIGN == 0
    covered = np.concatenate([np.arange(b, e) for b, e in bounds])
    np.testing.assert_array_equal(covered, np.arange(N))
    assert all(b % pk.ALIGN == 0 or b == N for b, _ in bounds)
    assert all(e - b <= slice_len for b, e in bounds)


def test_choose_splits_depends_on_shapes_only():
    assert pk.choose_splits(1536, 16384) == pk.choose_splits(1536, 16384)
    assert list(inspect.signature(pk.choose_splits).parameters) == ["Q", "N"]


@pytest.mark.parametrize("which", ["xla", "pallas"])
def test_knn_on_cpu_still_matches_the_reference(which):
    """``knn()`` on CPU tensors (the plain version) against the JAX functions,
    duplicated references included; empty slots carry index 0."""
    q, qm, r, rm = _cloud(64, 512, q_invalid=4, seed=6, dup=(which == "xla"))
    jargs = [jnp.asarray(a.numpy()) for a in (q, qm, r, rm)]
    if which == "xla":
        d_ref, _ = jn.knn(*jargs, k=5)
    else:
        d_ref, _ = knn_pallas(*jargs, k=5, tq=32, tn=128, interpret=True)
    d, i = pk.knn(q, qm, r, rm, k=5)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-5, atol=1e-5)
    assert bool((i[:4] == 0).all()) and i.dtype == torch.int32
    d2, i2, nbr = pk.knn_with_neighbors(q, qm, r, rm, k=5)
    assert torch.equal(d2, d) and torch.equal(i2, i) and torch.equal(nbr, r[i.long()])


def test_kernel_entries_refuse_cpu_tensors_and_bad_k():
    """Every kernel entry takes CUDA tensors only and raises on a CPU tensor
    before anything is built; there is no fallback inside them."""
    q, qm, r, rm = _cloud(8, 16)
    for call in (lambda: pk.knn_cuda(q, qm, r, rm, 5),
                 lambda: pk.knn_partial_cuda(q, qm, r, rm, 5, 1),
                 lambda: pk.knn_merge_cuda(torch.zeros(8, 2, 5), torch.zeros(8, 2, 5, dtype=torch.int32),
                                           qm, r, (None, None, None))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert "knn" not in port._build._libs  # nothing was built or loaded
    src = inspect.getsource(pk)
    assert "except" not in src  # no handler that could give way to the plain version
