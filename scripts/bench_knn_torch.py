#!/usr/bin/env python3
"""k-NN measurement harness of the port on the card.

``scripts/bench_knn.py`` through ``lmsf_slam_tpu_torch``: at its sizes
(1920×8192, 1920×16384 and 3840×65536 queries × references, uniform in
±50 m, every point valid) it times the hand-written kernels (``knn_cuda``:
the scan over reference slices and the merge), their plain torch version
(``knn_plain``) and ``torch.cdist`` + ``torch.topk`` with CUDA events
(launches queued back to back, after a warm-up), beside the bound (8 FP32
operations a query-reference pair at the card's peak). Every kernel result is
held against ``knn_plain``: distances to rtol 1e-6, indices exact wherever the
distances are distinct. The ``nvcc`` build time of ``csrc/knn.cu`` and the
first call (load and first launch) are reported apart from steady state.

    python3 scripts/bench_knn_torch.py [--sizes 1920x8192,1920x16384,3840x65536]
                                       [--k 5] [--iters 20] [--out FILE.json]

Prints one JSON line a size, then the card's name and power limit. Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="1920x8192,1920x16384,3840x65536",
                    help="comma-separated QxN list")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_knn_torch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from lmsf_slam_tpu_torch import _build
    from lmsf_slam_tpu_torch.ops import knn as K

    t0 = time.perf_counter()
    _build.build(["knn"])
    build_s = _build.build_info.get("knn", {}).get("seconds")  # None: already built
    dev = torch.device("cuda")
    rows = []
    first = True
    for spec in args.sizes.split(","):
        Q, N = (int(s) for s in spec.split("x"))
        g = np.random.default_rng((Q, N))
        q = torch.as_tensor(g.uniform(-50.0, 50.0, (Q, 3)), dtype=torch.float32, device=dev)
        r = torch.as_tensor(g.uniform(-50.0, 50.0, (N, 3)), dtype=torch.float32, device=dev)
        qm = torch.ones(Q, dtype=torch.bool, device=dev)
        rm = torch.ones(N, dtype=torch.bool, device=dev)
        k = args.k
        row = {"Q": Q, "N": N, "k": k, "splits": K.choose_splits(Q, N)}
        if first:  # the library's load and the first launch, after the build
            t1 = time.perf_counter()
            K.knn_cuda(q, qm, r, rm, k)
            torch.cuda.synchronize()
            row["first_call_s"] = time.perf_counter() - t1
            first = False
        err, n_tie = chip_smoke.compare_knn(K, q, qm, r, rm, k)

        def kern():
            return K.knn(q, qm, r, rm, k)

        def plain():
            return K.knn_plain(q, qm, r, rm, k)

        def lib():
            return torch.topk(torch.cdist(q, r), k, dim=1, largest=False)

        # in turns on one card: plain, kernel, library, kernel, plain
        p1, k1, l1, k2, p2 = (chip_smoke.cuda_ms(f, args.iters) for f in (plain, kern, lib, kern, plain))
        bound, by = chip_smoke.knn_bound_ms(Q, N, N, k)
        row.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=l1, bound_ms=bound,
                   bound_by=by, max_abs_err=err, near_tie_rows=n_tie)
        rows.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    summary = {"card": smi, "nvcc_build_s": build_s, "total_s": time.perf_counter() - t0,
               "rows": len(rows)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({**summary, "rows": rows}, fh, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
