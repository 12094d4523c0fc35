"""Share of the k-NN kernels' roofline in the traced frames, %: the summed
least time of the k-NN calls over the summed device time of
``knn_partial_kernel`` and ``knn_merge_kernel``. A call's least time is the
larger of 8 FP32 operations a valid query and valid reference at 67 TFLOP/s
and its bytes (queries, references and both masks read once, the (Q, k)
distances and indices, and the neighbours' coordinates where asked, written
once) at 3.35 TB/s: the H100 SXM's published peaks at 700 W."""

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
KERNELS = ("knn_partial_kernel", "knn_merge_kernel")


def least_seconds(q, q_valid, n, n_valid, k, neighbours=False):
    ops = 8.0 * q_valid * n_valid
    nbytes = q * 12 + q + n * 12 + n + q * k * 8 + (q * k * 12 if neighbours else 0)
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def read(ctx):
    trace = ctx.get("trace")
    calls = ctx.get("knn_calls")
    if not trace or not calls:
        return None
    busy = sum(d for name, _, d, _ in trace["device"] if any(k in name for k in KERNELS)) * 1e-9
    if busy <= 0:
        return None
    return 100.0 * sum(least_seconds(*c) for c in calls) / busy
