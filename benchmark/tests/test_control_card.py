"""The control on the card, at each cell's own size: three seeds, a short
window at the cell's own load, the system's readings and the control's of
the same runs. Every limit must lie above the system's readings, and the
control must break at least one of them on every seed.

    python3 -m pytest benchmark/tests/test_control_card.py -m cuda -q -s

(Minutes a cell: each seed pays the cell's whole set-up.)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import json
import time

import pytest

from benchmark import harness

CELLS = ["hdl64_city.paced", "vlp16_default.explore"]
SEEDS = [3000000001, 3000000002, 3000000003]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_system_passes(workload, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run only on one")
    for seed in SEEDS:
        rc = harness.run(["--workload", workload, "--seed", str(seed), "--seconds", "10",
                          "--trace", "0"], time.perf_counter(), control=True)
        out, _ = capsys.readouterr()
        assert rc == 0
        res = json.loads(out.strip().splitlines()[-1])
        assert res["correct"] is True, res["check"]
        broken = [k for k, v in res["check"].items() if res["control"].get(k, 0.0) > v["limit"]]
        assert broken, (res["check"], res["control"])
