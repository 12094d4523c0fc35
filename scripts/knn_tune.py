#!/usr/bin/env python3
"""Sweep the k-NN kernels' launch parameters on the card.

    python3 scripts/knn_tune.py [--out FILE.json]

For each of the frame's three shapes (edge 384×8192 k=5, surf 1536×16384 k=5,
nn1 1920×24576 k=1) and each number of reference slices S and lanes a query
L, it prints the device time of the whole search (scan + merge kernels, CUDA
events, launches queued back to back) and of the scan kernel alone, with the
grid size. The row marked ``*`` is what ``choose_splits`` and the default
lanes pick. Every result is checked against the default's, bit for bit.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = [("edge", 384, 8192, 5), ("surf", 1536, 16384, 5), ("nn1", 1920, 24576, 1)]
SPLITS = [1, 2, 4, 6, 8, 12, 16, 22, 32, 48]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the table to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("knn_tune: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from lmsf_slam_tpu_torch.ops import knn as K

    dev = torch.device("cuda")
    rows = []
    for i, (name, Q, N, k) in enumerate(SHAPES):
        q, qm, r, rm = chip_smoke.knn_case(Q, N, 0, 0.7, seed=i, dev=dev)
        chosen = K.choose_splits(Q, N)
        d0, i0, _ = K.knn_cuda(q, qm, r, rm, k)
        for lanes in (8, 4):
            for S in sorted(set(SPLITS + [chosen])):
                if N // S < 64:
                    continue
                d, idx, _ = K.knn_cuda(q, qm, r, rm, k, splits=S, lanes=lanes)
                if not (torch.equal(d, d0) and torch.equal(idx, i0)):
                    raise RuntimeError(f"{name}: S={S} L={lanes} changes the result")
                out = (torch.empty_like(d), torch.empty_like(idx), None)
                total = chip_smoke.cuda_ms(
                    lambda: K.knn_cuda(q, qm, r, rm, k, splits=S, lanes=lanes), 50)
                scan = chip_smoke.cuda_ms(
                    lambda: K.knn_partial_cuda(q, qm, r, rm, k, S, lanes, out), 50)
                blocks = -(-Q // (K.THREADS // lanes)) * S
                mark = "*" if (S == chosen and lanes == K.LANES) else " "
                print(f"{mark} {name} {Q}x{N} k={k} L={lanes} S={S:3d} blocks={blocks:5d} "
                      f"total {total:.4f} ms, scan alone {scan:.4f} ms", flush=True)
                rows.append({"shape": name, "Q": Q, "N": N, "k": k, "lanes": lanes, "splits": S,
                             "blocks": blocks, "ms": total, "scan_ms": scan,
                             "default": mark == "*"})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "tile": K.TILE, "threads": K.THREADS, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
