"""The control on the card for the LiDAR-inertial city, at the cell's own
size: three seeds, a short window at the cell's own rate, the system's
readings and the control's of the same runs (clouds, poses, IMU windows and
filter states in bfloat16). Every limit must lie above the system's
readings, and the control must break at least one of them on every seed.

    python3 -m pytest benchmark/tests/test_control_card_lio.py -m cuda -q -s

(Minutes: each seed pays the cell's whole set-up.)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import json
import time

import pytest

from benchmark import harness

WORKLOAD = "hdl64_city_lio.paced_imu"
SEEDS = [3000000011, 3000000012, 3000000013]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_where_the_system_passes(seed, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cell runs only on one")
    rc = harness.run(["--workload", WORKLOAD, "--seed", str(seed), "--seconds", "10",
                      "--trace", "0"], time.perf_counter(), control=True)
    out, _ = capsys.readouterr()
    assert rc == 0
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["check"]
    broken = [k for k, v in res["check"].items() if res["control"].get(k, 0.0) > v["limit"]]
    assert broken, (res["check"], res["control"])
