"""Whole runs of the harness at a tiny size on the CPU: a cell, a traffic
mix and a per-layer metric added from files alone; the last line's schema;
the faults the check has to catch; the control against the reference; and
the reference's isolation from the system and from JAX."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY_CONFIG = {
    "sensor": {"rings": 16, "width": 360, "max_range": 40.0},
    "system": {"feature": {"rings": 16, "width": 360, "edges_per_sector": 2, "surfs_per_sector": 6},
               "tracker_window": 6, "registration": {"max_iters": 6, "max_corr_dist": 1.0},
               "async_backend": True,
               "lifelong": {"optimize_batch": 3, "optimize_window": 4, "graph_pad_min": 16,
                            "window_pad_min": 16}},
    "storage": "memmap",
}
TINY_MIX = {"loop": "closed", "course": "line", "world": {"extent": 30.0, "n_boxes": 14, "n_cylinders": 24},
            "step_m": 0.47, "z": 1.4, "setup": "warmup", "warmup_frames": 2, "pool_frames": 400,
            "check_span": 6, "check_frames": 3}
# the revisit cell in small: 60-frame laps, loop gates low enough that lap 2
# closes the loop in set-up and the window localizes
TINY_LOOP = {"min_frame_interval": 12, "exclude_recent": 6, "detect_spacing": 1,
             "search_radius": 10.0}
TINY_CIRCLE = {"loop": "closed", "course": "circle",
               "world": {"extent": 30.0, "n_boxes": 14, "n_cylinders": 24},
               "frames_per_lap": 60, "radius": 9.0, "z": 1.4, "setup": "first_loop",
               "setup_max_frames": 200, "pool_frames": 300, "check_span": 6, "check_frames": 3}
LIMITS = {"frame_gap_m": 1e-3, "map_gap_m": 1e-3, "store_gap_m": 1e-3, "graph_gap_m": 1e-3}
# a metric that exists only in this test's files
FRAMES_SEEN = '"""Frames the window returned, frames."""\n\n\ndef read(ctx):\n    return float(ctx["n_frames"])\n'


def make_root(tmp_path, limits=None, revisit=False):
    """A checkout with BENCHMARK.json naming one new cell, and that cell's
    configuration, mix, limits and one new metric as files; the metric
    readers of the benchmark are copied beside the new one. ``revisit``
    makes the cell a small copy of the revisit cell (under the same name)."""
    base = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (base / sub).mkdir(parents=True)
    for f in (BENCH / "metrics").glob("*.py"):
        shutil.copy(f, base / "metrics" / f.name)
    (base / "metrics" / "tiny.frames_seen.py").write_text(FRAMES_SEEN)
    config = json.loads(json.dumps(TINY_CONFIG))
    if revisit:
        config["system"]["loop"] = TINY_LOOP
    (base / "configs" / "tiny.json").write_text(json.dumps(config))
    (base / "traffic" / "tinyline.json").write_text(json.dumps(TINY_CIRCLE if revisit else TINY_MIX))
    lim = limits or (dict(LIMITS, loop_gap_m=1e-3, loc_gap_m=1e-3) if revisit else LIMITS)
    (base / "limits" / "tiny.tinyline.json").write_text(json.dumps(lim))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["paths"] = ["bench"]
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "bench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny.tinyline", "config": "tiny", "traffic": "tinyline",
                           "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["per_layer"].append({"name": "tiny.frames_seen", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "frame_p50_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def run_tiny(root, capsys, trace=0, seconds=3.0, control=False):
    rc = harness.run(["--workload", "tiny.tinyline", "--seed", str(2**31 + 77), "--seconds",
                      str(seconds), "--trace", str(trace)], time.perf_counter(), device="cpu",
                     root=root, control=control)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.fixture(scope="module")
def torch_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_files_alone_add_a_cell_a_mix_and_a_metric(tmp_path, capsys, torch_threads):
    res, err = run_tiny(make_root(tmp_path), capsys)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "check"
    assert res["correct"] is True, err[-2000:]
    assert set(res["metrics"]) == {"frames_per_s", "frame_p50_ms", "frame_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in res["metrics"].values())
    assert res["attempted"] == len([1]) * res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # the numbers compared close stderr, each beside its limit
    tail = err.strip().splitlines()[-4:]
    assert all(line.startswith("check ") and "limit" in line for line in tail)

    res, _ = run_tiny(make_root(tmp_path / "t"), capsys, trace=1)
    assert res["metrics"]["tiny.frames_seen"]["value"] == res["attempted"]
    assert "frame_p50_ms" not in res["metrics"]
    assert res["metrics"]["backend.stage_ms_per_frame"]["value"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["state_unchanged", "pose_altered"])
def test_faults_of_the_timed_path_read_not_correct(fault, tmp_path, capsys, monkeypatch,
                                                   torch_threads):
    from lmsf_slam_tpu_torch.system import ml_system

    if fault == "state_unchanged":
        real = ml_system.tracker_step

        def step(state, *a, **kw):
            _, out = real(state, *a, **kw)
            return state, out

        monkeypatch.setattr(ml_system, "tracker_step", step)
    else:
        real_read = ml_system._read_back

        def read_back(out):
            pose, conv, n = real_read(out)
            pose = pose.copy()
            pose[4] += 0.05
            return pose, conv, n

        monkeypatch.setattr(ml_system, "_read_back", read_back)
    res, _ = run_tiny(make_root(tmp_path), capsys)
    assert res["correct"] is False
    failed = {k for k, v in res["check"].items() if v["value"] is None or v["value"] > v["limit"]}
    # a ring that never fills disagrees with the insertion rule; an altered
    # pose lies off the reference's registration
    assert "frame_gap_m" in failed


def test_revisit_judges_the_window_localizations(tmp_path, capsys, torch_threads):
    res, err = run_tiny(make_root(tmp_path, revisit=True), capsys, seconds=4.0)
    assert res["correct"] is True, err[-2000:]
    assert res["check"]["loc_gap_m"]["value"] < 1e-4
    assert res["check"]["loop_gap_m"]["value"] < 1e-4


def test_a_localization_pose_altered_reads_not_correct(tmp_path, capsys, monkeypatch,
                                                       torch_threads):
    from lmsf_slam_tpu_torch.backend import lifelong

    real = lifelong.register_and_score

    def shifted(*a, **kw):
        reg, score, overlap = real(*a, **kw)
        pose = reg.pose.clone()
        pose[4] += 0.05
        return reg._replace(pose=pose), score, overlap

    monkeypatch.setattr(lifelong, "register_and_score", shifted)
    res, _ = run_tiny(make_root(tmp_path, revisit=True), capsys, seconds=4.0)
    assert res["correct"] is False
    assert res["check"]["loc_gap_m"]["value"] > res["check"]["loc_gap_m"]["limit"]


def test_the_control_reads_far_above_the_system(tmp_path, capsys, torch_threads):
    res, _ = run_tiny(make_root(tmp_path), capsys, control=True)
    assert res["correct"] is True
    prog = {k: v["value"] for k, v in res["check"].items()}
    ctl = res["control"]
    # the control (bfloat16 storage) fails the limits the system meets
    assert any(ctl[k] > res["check"][k]["limit"] for k in prog)
    assert ctl["frame_gap_m"] > 3 * prog["frame_gap_m"]


def test_the_reference_imports_neither_the_system_nor_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.check, "
            "benchmark.gen.sim, benchmark.gen.city, benchmark.traffic; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    tops = set(eval(out.stdout))
    assert not tops & {"jax", "jaxlib", "flax", "lmsf_slam_tpu", "lmsf_slam_tpu_torch"}


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, time, json; sys.path.insert(0, %r); import torch; "
            "torch.set_num_threads(2); from benchmark import harness; "
            "rc = harness.run(['--workload', 'tiny.tinyline', '--seed', '5', '--seconds', '1', "
            "'--trace', '0'], time.perf_counter(), device='cpu', root=%r); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % (str(ROOT), str(make_root(tmp_path))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "lmsf_slam_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "lmsf_slam_tpu"}


def test_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.run(["--workload", "vlp16_default.explore", "--seed", "1", "--seconds", "1",
                      "--trace", "0"], time.perf_counter())
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""
