"""Two intra-op threads for torch in the port's CPU tests.

Imported by every ``tests/test_torch_*.py`` (its effect is process-wide, so
the first import sets it). The port's CPU tests run thousands of small
tensor ops a frame, where torch's default of one thread a core spends more
time waking and joining threads than computing: six frames of the two-LiDAR
course took 27.0 s with 8 threads and 10.3 s with 1 in an otherwise idle
process on an 8-core host, and under ``pytest -n 6`` every worker's threads
compete for the same cores. Two, not one: with one thread torch's CPU
kernels take another summation path, and two parity tests whose tolerances
were set on the threaded path (``test_torch_loop_closure.py``'s fused
verification score, ``test_torch_schur_city.py``'s final chi2) land outside
them; with 2, 4 or 8 threads both pass.
"""
import torch

torch.set_num_threads(2)
