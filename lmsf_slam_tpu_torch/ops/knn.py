"""Exact k-NN: the hand-written CUDA kernels and their plain torch versions.

Counterpart of ``lmsf_slam_tpu/ops/pallas_knn.py`` (the reference's one TPU
kernel, ``_knn_kernel``, with its wrapper ``knn_pallas``). Here it is the
port's k-NN on every path: the registration's edge and surf association, and
``nn1`` for the flow gate and the probation gate.

:func:`knn` keeps the reference contract (``neighbors.knn``): ascending exact
squared distances, ties to the lowest reference index, INF where a slot has
no valid neighbour or the query is masked, int32 indices into the reference
cloud (0 where the distance is INF).

- CUDA tensors go to :func:`knn_cuda` — ``csrc/knn.cu``. The references are
  split into ``S`` slices across the grid (:func:`choose_splits`), ``L`` lanes
  of a warp serve one query, and a second kernel merges the ``S`` partial
  lists and writes the final outputs, query mask applied. Nothing runs after
  the launches. It launches or raises; there is no fallback.
- CPU tensors go to :func:`knn_plain`: the expansion ``|q|² + |p|² − 2 q·p``
  of the reference's ``neighbors._knn_block`` with an exact top-k
  (:func:`knn_reference`), then the reference's tail (:func:`rescore`).

:func:`knn_split_merge_plain` is a plain torch model of the kernels'
decomposition (slices × lane strides, per-part top-k, lexicographic merge on
``(d, idx)``), so the tie and merge logic is testable without a card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

INF = 3.4e38  # float32(3.4e38), the reference's "no neighbour" distance
K_MAX = 8

# Mirrors of the constants in csrc/knn.cu (checked when the library loads).
THREADS = 256  # threads a block
TILE = 512  # reference points staged at a time
ALIGN = 16  # slices start at multiples of this many points
MERGE_LANES = 8  # lanes a query in the merge kernel
LANES = 8  # lanes a query in the scan (the kernel also takes 4)

# choose_splits: at least TARGET_BLOCKS blocks (two an SM on 132 SMs), slices
# of at most MAX_SLICE points (scan depth MAX_SLICE / LANES a lane) and at
# least MIN_SLICE (a shorter slice is all launch and merge).
TARGET_BLOCKS = 264
MAX_SLICE = 2048
MIN_SLICE = 256

_KERNEL = "knn"
_MERGE = "knn_merge"


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def choose_splits(Q: int, N: int) -> int:
    """Number of reference slices S for a (Q, N) problem: a function of the
    shapes alone, so the launch is the same every frame."""
    query_tiles = _ceil_div(max(Q, 1), THREADS // LANES)
    want = max(_ceil_div(TARGET_BLOCKS, query_tiles), _ceil_div(N, MAX_SLICE))
    return max(1, min(want, N // MIN_SLICE))


def slice_length(N: int, splits: int) -> int:
    """Points a slice: ceil(N / splits) rounded up to ALIGN points, so every
    slice starts 16-byte aligned in both the xyz and the mask array."""
    return _ceil_div(_ceil_div(max(N, 1), splits), ALIGN) * ALIGN


def slice_bounds(N: int, splits: int):
    """[(begin, end), ...] of the ``splits`` contiguous slices of
    :func:`slice_length` points: the ragged end is cut at N and trailing
    slices may be empty. Together the slices cover range(N) exactly once."""
    slice_len = slice_length(N, splits)
    return [(min(N, s * slice_len), min(N, (s + 1) * slice_len)) for s in range(splits)]


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def knn_reference(query_xyz, ref_xyz, ref_mask, k: int):
    """Plain torch candidates: (Q,k) distances (expansion form) and int32
    indices of the k nearest valid references, ascending; INF slots where
    fewer than k references are valid. The (Q,N) matrix is updated in place
    ((|q|² + |p|²) − 2·q·p, clamped, masked: the same roundings as
    out-of-place ops, with one (Q,N) buffer besides the product's)."""
    q = query_xyz.to(torch.float32)
    q_norm = torch.sum(q * q, dim=-1, keepdim=True)
    p_norm = torch.sum(ref_xyz * ref_xyz, dim=-1)
    d = q_norm + p_norm[None, :]
    d.sub_((q @ ref_xyz.T).mul_(2.0))
    d.clamp_(min=0.0).masked_fill_(~ref_mask[None, :], INF)
    best_d, best_i = torch.topk(d, k, dim=1, largest=False, sorted=True)
    return best_d, best_i.to(torch.int32)


def rescore(q, query_mask, ref_xyz, best_d, best_i):
    """The reference's tail: exact distances of the k winners (the expansion
    form cancels at long range), stable ascending sort, INF restored where a
    slot had no valid neighbour or the query is masked."""
    nbr = ref_xyz[best_i.long()]  # (Q,k,3); candidate indices are in range
    diff = q[:, None, :] - nbr
    exact = torch.sum(diff * diff, dim=-1)
    exact = torch.where(best_d < INF, exact, INF)
    exact, order = torch.sort(exact, dim=1, stable=True)
    best_i = torch.take_along_dim(best_i, order, dim=1)
    exact = torch.where(query_mask[:, None], exact, INF)
    return exact, best_i


def knn_plain(query_xyz, query_mask, ref_xyz, ref_mask, k: int):
    """The plain version of the whole function: :func:`knn_reference`, then
    :func:`rescore`, then index 0 wherever the distance is INF. Taken for CPU
    tensors, and by comparisons with the kernels. On the CPU the masked
    queries' rows are left out of the (Q,N) matrix (their result is INF and
    index 0 whatever they hold; each row's arithmetic is its own, so the
    other rows are unchanged); on a card that would cost a host sync."""
    if query_xyz.is_cuda:
        best_d, best_i = knn_reference(query_xyz, ref_xyz, ref_mask, k)
    else:
        rows = torch.nonzero(query_mask).squeeze(1)
        best_d = query_xyz.new_full((query_xyz.shape[0], k), INF)
        best_i = torch.zeros((query_xyz.shape[0], k), dtype=torch.int32)
        best_d[rows], best_i[rows] = knn_reference(query_xyz[rows], ref_xyz, ref_mask, k)
    d, i = rescore(query_xyz, query_mask, ref_xyz, best_d, best_i)
    return d, torch.where(d < INF, i, 0)


def pair_distances(query_xyz, ref_xyz):
    """(Q,N) exact squared distances, summed as the kernel sums them:
    (dx·dx + dy·dy) + dz·dz, every product and sum rounded to float32."""
    dx = query_xyz[:, None, 0] - ref_xyz[None, :, 0]
    dy = query_xyz[:, None, 1] - ref_xyz[None, :, 1]
    dz = query_xyz[:, None, 2] - ref_xyz[None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def _lex_topk(d, idx, k: int):
    """The k smallest columns of each row by (d, idx): (Q,k) of each."""
    order = torch.argsort(idx, dim=1, stable=True)
    d, idx = torch.take_along_dim(d, order, dim=1), torch.take_along_dim(idx, order, dim=1)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    return torch.take_along_dim(d, order, dim=1), torch.take_along_dim(idx, order, dim=1)


def merge_partials_plain(part_d, part_i, query_mask, k: int):
    """Plain version of the merge kernel: (Q,S,k) sorted partial lists, empty
    slots (INF, 0), merged by (d, idx) into the final (Q,k) outputs."""
    Q = part_d.shape[0]
    d, i = _lex_topk(part_d.reshape(Q, -1), part_i.reshape(Q, -1), k)
    d = torch.where(query_mask[:, None], d, INF)
    return d, torch.where(d < INF, i, 0)


def knn_split_merge_plain(query_xyz, query_mask, ref_xyz, ref_mask, k: int,
                          splits: int = 1, lanes: int = 1):
    """Plain torch model of the kernels' decomposition: the references are
    cut into ``splits`` contiguous slices (:func:`slice_bounds`) and each slice
    into ``lanes`` strides; each part keeps its k best by (exact distance,
    index); the parts are merged lexicographically. The result does not
    depend on ``splits`` or ``lanes``."""
    Q, N = query_xyz.shape[0], ref_xyz.shape[0]
    dev = query_xyz.device
    d_all = torch.where(ref_mask[None, :], pair_distances(query_xyz, ref_xyz), INF)
    parts_d, parts_i = [], []
    for begin, end in slice_bounds(N, splits):
        for lane in range(lanes):
            idx = torch.arange(begin + lane, max(end, begin + lane), lanes, device=dev)
            d = d_all[:, idx]
            pad = k - idx.numel()
            if pad > 0:
                d = torch.cat([d, torch.full((Q, pad), INF, device=dev)], dim=1)
                idx = torch.cat([idx, torch.zeros(pad, dtype=idx.dtype, device=dev)])
            i = idx[None, :].expand(Q, -1)
            i = torch.where(d < INF, i, 0)
            d, i = _lex_topk(d, i, k)
            parts_d.append(d)
            parts_i.append(i.to(torch.int32))
    return merge_partials_plain(torch.stack(parts_d, dim=1), torch.stack(parts_i, dim=1),
                                query_mask, k)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_typed: set[str] = set()  # libraries whose entry points have their argument types


def _library():
    """``csrc/knn.cu`` built and loaded at first use, its entry points typed
    (an untyped pointer argument would be cut to 32 bits)."""
    lib = _build.load(_KERNEL)
    if _KERNEL in _typed:
        return lib
    with _build.lock:  # two threads may reach the first launch together
        if _KERNEL in _typed:
            return lib
        for name, argtypes in (
            ("knn_partial_launch", [_PTR] * 4 + [_INT] * 6 + [_PTR] * 6),
            ("knn_merge_launch", [_PTR] * 4 + [_INT] * 3 + [_PTR] * 4),
            ("knn_empty_launch", [_PTR]),
            ("knn_threads", []), ("knn_tile", []), ("knn_align", []), ("knn_merge_lanes", []),
        ):
            fn = getattr(lib, name)
            fn.restype = _INT
            fn.argtypes = argtypes
        built = (lib.knn_threads(), lib.knn_tile(), lib.knn_align(), lib.knn_merge_lanes())
        if built != (THREADS, TILE, ALIGN, MERGE_LANES):
            raise RuntimeError(f"knn.cu was built with {built}, the wrapper expects "
                               f"{(THREADS, TILE, ALIGN, MERGE_LANES)}")
        _build.launches.setdefault(_MERGE, 0)
        _typed.add(_KERNEL)  # last: a reader of the set sees every entry point typed
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_inputs(query_xyz, query_mask, ref_xyz, ref_mask, k):
    dev = query_xyz.device
    if dev.type != "cuda":
        raise ValueError(f"the knn kernel needs CUDA tensors, got {dev}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"the knn kernel takes 1 <= k <= {K_MAX}, got k={k}")
    for name, t, dtype, ndim in (
        ("query_xyz", query_xyz, torch.float32, 2),
        ("query_mask", query_mask, torch.bool, 1),
        ("ref_xyz", ref_xyz, torch.float32, 2),
        ("ref_mask", ref_mask, torch.bool, 1),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, query on {dev}")
        if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {ndim}-d {dtype} tensor, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    Q, N = query_xyz.shape[0], ref_xyz.shape[0]
    if (query_xyz.shape[1] != 3 or ref_xyz.shape[1] != 3
            or query_mask.shape[0] != Q or ref_mask.shape[0] != N):
        raise ValueError(
            f"shapes {tuple(query_xyz.shape)}, {tuple(query_mask.shape)}, "
            f"{tuple(ref_xyz.shape)}, {tuple(ref_mask.shape)} are not (Q,3), (Q,), (N,3), (N,)"
        )
    return dev, Q, N


def _check_out(out, Q, k, dev):
    """``out`` = (d (Q,k) float32, idx (Q,k) int32, neighbours (Q,k,3) float32
    or None), contiguous on ``dev``: what the kernels write into."""
    if out is None or len(out) != 3:
        raise ValueError("out must be (distances, indices, neighbours or None)")
    for name, t, dtype, shape in (("out distances", out[0], torch.float32, (Q, k)),
                                  ("out indices", out[1], torch.int32, (Q, k)),
                                  ("out neighbours", out[2], torch.float32, (Q, k, 3))):
        if t is None and shape == (Q, k, 3):
            continue
        if (t is None or t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor {shape} on {dev}")


def knn_partial_cuda(query_xyz, query_mask, ref_xyz, ref_mask, k: int, splits: int,
                     lanes: int = LANES, out=None):
    """Launch the scan kernel. With ``splits > 1`` it returns the sorted
    partial lists, (Q,splits,k) distances and int32 indices with empty slots
    (INF, 0), for :func:`knn_merge_cuda`; with ``splits == 1`` it writes the
    final outputs into ``out`` = (d, idx, neighbours or None) and returns
    ``out``."""
    dev, Q, N = _check_inputs(query_xyz, query_mask, ref_xyz, ref_mask, k)
    if Q == 0 or N == 0:
        raise ValueError(f"nothing to launch for Q={Q}, N={N}")
    return _launch_partial(dev, Q, N, query_xyz, query_mask, ref_xyz, ref_mask, k, splits,
                           lanes, out)


def _launch_partial(dev, Q, N, query_xyz, query_mask, ref_xyz, ref_mask, k, splits, lanes, out):
    if lanes not in (4, 8):
        raise ValueError(f"the knn kernel takes 4 or 8 lanes a query, got {lanes}")
    if splits < 1:
        raise ValueError(f"splits must be at least 1, got {splits}")
    # cp.async moves 16-byte chunks: a view that starts off that alignment is
    # copied to a fresh allocation. (The copy and the scratch below are
    # dropped when this call returns, before the kernels have run; the caching
    # allocator hands their memory only to later work on the same stream.)
    if ref_xyz.data_ptr() % 16:
        ref_xyz = ref_xyz.clone()
    if ref_mask.data_ptr() % 16:
        ref_mask = ref_mask.clone()
    slice_len = slice_length(N, splits)
    if splits == 1:
        _check_out(out, Q, k, dev)
        part = (None, None)
        final = out
    else:
        part = (torch.empty((Q, splits, k), dtype=torch.float32, device=dev),
                torch.empty((Q, splits, k), dtype=torch.int32, device=dev))
        final = (None, None, None)
    lib = _library()
    with _build.on_device(dev):
        rc = lib.knn_partial_launch(
            query_xyz.data_ptr(), query_mask.data_ptr(), ref_xyz.data_ptr(),
            ref_mask.data_ptr(), Q, N, k, splits, lanes, slice_len,
            _ptr(part[0]), _ptr(part[1]), _ptr(final[0]), _ptr(final[1]), _ptr(final[2]),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"knn kernel launch failed: CUDA error {rc}")
    _build.count_launch(_KERNEL)
    return out if splits == 1 else part


def knn_merge_cuda(part_d, part_i, query_mask, ref_xyz, out):
    """Launch the merge kernel: (Q,S,k) partial lists into ``out`` = (d, idx,
    neighbours or None), query mask applied."""
    Q, S, k = part_d.shape
    dev = part_d.device
    if dev.type != "cuda":
        raise ValueError(f"the knn merge kernel needs CUDA tensors, got {dev}")
    for name, t, dtype in (("part_d", part_d, torch.float32), ("part_i", part_i, torch.int32),
                           ("query_mask", query_mask, torch.bool),
                           ("ref_xyz", ref_xyz, torch.float32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}")
    if part_i.shape != part_d.shape or query_mask.shape != (Q,) or not 1 <= k <= K_MAX:
        raise ValueError(f"shapes {tuple(part_d.shape)}, {tuple(part_i.shape)}, "
                         f"{tuple(query_mask.shape)} are not (Q,S,k), (Q,S,k), (Q,)")
    _check_out(out, Q, k, dev)
    lib = _library()
    with _build.on_device(dev):
        rc = lib.knn_merge_launch(
            part_d.data_ptr(), part_i.data_ptr(), query_mask.data_ptr(), ref_xyz.data_ptr(),
            Q, S, k, out[0].data_ptr(), out[1].data_ptr(), _ptr(out[2]),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"knn merge kernel launch failed: CUDA error {rc}")
    _build.count_launch(_MERGE)
    return out


def knn_cuda(query_xyz, query_mask, ref_xyz, ref_mask, k: int, splits=None,
             lanes: int = LANES, neighbors: bool = False):
    """The whole function on CUDA tensors (float32 contiguous (Q,3) and (N,3),
    bool (Q,) and (N,)): final (Q,k) distances and int32 indices, and with
    ``neighbors`` the (Q,k,3) coordinates ``ref_xyz[idx]`` as well (else
    None). ``splits`` defaults to :func:`choose_splits`; the result does not
    depend on ``splits`` or ``lanes``."""
    dev, Q, N = _check_inputs(query_xyz, query_mask, ref_xyz, ref_mask, k)
    if Q == 0 or N == 0:  # nothing to search: every slot is INF
        return (torch.full((Q, k), INF, dtype=torch.float32, device=dev),
                torch.zeros((Q, k), dtype=torch.int32, device=dev),
                torch.zeros((Q, k, 3), dtype=torch.float32, device=dev) if neighbors else None)
    if splits is None:
        splits = choose_splits(Q, N)
    out = (torch.empty((Q, k), dtype=torch.float32, device=dev),
           torch.empty((Q, k), dtype=torch.int32, device=dev),
           torch.empty((Q, k, 3), dtype=torch.float32, device=dev) if neighbors else None)
    part = _launch_partial(dev, Q, N, query_xyz, query_mask, ref_xyz, ref_mask, k, splits,
                           lanes, out)
    if splits == 1:
        return out
    return knn_merge_cuda(part[0], part[1], query_mask, ref_xyz, out)


def empty_launch_cuda():
    """Launch an empty kernel on the current stream (what a launch costs)."""
    rc = _library().knn_empty_launch(torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


def _as(t, dtype):
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _prepare(query_xyz, query_mask, ref_xyz, ref_mask):
    return (_as(query_xyz, torch.float32), _as(query_mask, torch.bool),
            _as(ref_xyz, torch.float32), _as(ref_mask, torch.bool))


def knn(query_xyz, query_mask, ref_xyz, ref_mask, k: int = 5):
    """k nearest valid references of each query (reference ``neighbors.knn``
    contract). The kernels serve CUDA tensors; CPU tensors take the plain
    version."""
    q, qm, r, rm = _prepare(query_xyz, query_mask, ref_xyz, ref_mask)
    if q.device.type == "cpu":
        return knn_plain(q, qm, r, rm, k)
    return knn_cuda(q, qm, r, rm, k)[:2]


def knn_with_neighbors(query_xyz, query_mask, ref_xyz, ref_mask, k: int = 5):
    """:func:`knn` plus the neighbours' coordinates (Q,k,3) = ``ref_xyz[idx]``
    in float32: on the card the merge kernel writes them, on the CPU they are
    gathered."""
    q, qm, r, rm = _prepare(query_xyz, query_mask, ref_xyz, ref_mask)
    if q.device.type == "cpu":
        d, i = knn_plain(q, qm, r, rm, k)
        return d, i, r[i.long()]
    return knn_cuda(q, qm, r, rm, k, neighbors=True)
