"""The port stands alone: neither ``lmsf_slam_tpu_torch`` nor ``chip_smoke.py``
imports ``jax`` or the reference package ``lmsf_slam_tpu``, at run time
(every module imported in a fresh interpreter) or in the source (no import
statement names them). Importing the package does not import ``yaml`` either:
the machine with the card has none, and only the config loader needs it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from tests import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "lmsf_slam_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "lmsf_slam_tpu")
# not imported when the package and chip_smoke.py are (it may be imported
# inside the function that loads a YAML file)
FORBIDDEN_AT_IMPORT = FORBIDDEN + ("yaml",)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax_at_run_time():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lmsf_slam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        f"bad = sorted(n for n in sys.modules if any(n == f or n.startswith(f + '.') for f in {FORBIDDEN_AT_IMPORT!r}))\n"
        "assert not bad, bad\n"
        f"missing = sorted(set({IMU_MODULES + MULTI_MODULES + TOOLING_MODULES + MESH_MODULES!r}) - {{n[len(p.__name__) + 1:] for n in names}})\n"
        "assert not missing, missing\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 50  # every module of the slices was imported


def test_port_source_names_no_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


LIFELONG_MODULES = ("backend.async_backend", "backend.session_merge", "ops.dynamic", "mapping",
                    "mapping.occupancy", "datasets.city")
# the IMU/GNSS stack, host-only modules included (the reference's gnss, nmea
# and sync import no JAX either, but importing them runs its __init__)
IMU_MODULES = ("estimator", "estimator.eskf", "estimator.preintegration", "estimator.gnss",
               "estimator.nmea", "lio", "lio.lio_tracker", "backend.lio_graph", "common.sync",
               "datasets.simulator")
# a kernel's wrapper, which also loads its library with ctypes
KERNEL_MODULES = ("ops.projector",)
# the modules that load a kernel's library with ctypes: the projector's
# wrapper, and the IMU stack's filter (the ESKF propagation's kernel)
CTYPES_MODULES = KERNEL_MODULES + ("estimator.eskf",)
# the submap Schur solve and the hand-eye calibration of several LiDARs
MULTI_MODULES = ("parallel", "parallel.schur", "calibration", "calibration.handeye")


# NDT's voxel statistics, the KITTI entry point and its tooling
TOOLING_MODULES = ("ops.voxel", "ops.registration", "datasets.kitti", "datasets.synthetic",
                   "native", "native.bindings", "evaluation.metrics", "evaluation.render",
                   "common.databus", "utils.profiling", "entry")
SCRIPTS = ("scripts/evaluate_torch.py", "scripts/fuse_sessions_torch.py",
           # the scripts beside the north-star benchmark
           "bench_torch.py", "scripts/profile_frontend_torch.py", "scripts/render_map_torch.py",
           "scripts/bench_knn_torch.py")
# beyond one device: the mesh and its collectives, the edge-sharded solve and
# batched registration, the offline mapping, the bootstrap of several
# processes; and the functions the multi-rank tests run in each rank (a
# spawned rank imports them by name, so they must not import JAX either)
MESH_MODULES = ("parallel.distributed", "parallel.offline_mapping", "parallel.multihost")
RANK_HELPERS = ROOT / "tests" / "torch_ranks.py"


@pytest.mark.parametrize("module",
                         LIFELONG_MODULES + IMU_MODULES + KERNEL_MODULES + MULTI_MODULES)
def test_lifelong_modules_name_no_jax(module):
    """Each module of the lifelong deployment, of the IMU/GNSS stack, the
    projector kernel's wrapper, the Schur solve and the hand-eye calibration: no
    import statement, at any depth (a function body included), names JAX or
    the reference package, and what it imports from this package exists."""
    path = PACKAGE / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = PACKAGE / module.replace(".", "/") / "__init__.py"
    tree = ast.parse(path.read_text(), str(path))
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported.append(("." * node.level) + (node.module or ""))
    assert imported and not any(_forbidden(n) for n in imported), imported
    roots = {n.split(".")[0] for n in imported if not n.startswith(".")}
    allowed = {"__future__", "contextlib", "threading", "time", "collections", "typing", "math",
               "numpy", "torch"} | ({"ctypes"} if module in CTYPES_MODULES else set())
    assert roots <= allowed, roots


def test_lifelong_modules_import_no_jax_at_run_time():
    code = (
        "import importlib, sys\n"
        f"for n in {LIFELONG_MODULES + IMU_MODULES + KERNEL_MODULES + MULTI_MODULES!r}: "
        "importlib.import_module('lmsf_slam_tpu_torch.' + n)\n"
        "from lmsf_slam_tpu_torch.system.config import system_config_from_yaml\n"
        "from lmsf_slam_tpu_torch.system import MultiLidarSystem\n"
        "s = MultiLidarSystem(system_config_from_yaml('config/default.yaml'), device='cpu')\n"
        "assert s._async is not None\n"
        f"bad = sorted(n for n in sys.modules if any(n == f or n.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No card: exit non-zero and print no result line. Alone in a directory
    (without the package) it fails as well."""
    if torch.cuda.is_available():
        return  # on a machine with a card the script runs for real
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=_clean_env(),
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_every_entry_point_defaults_to_the_card():
    """A function or method of the port that has a default for ``device``
    defaults it to ``"cuda"``: the CPU is used only when the caller asks for
    it. (Helpers that require the argument pass their caller's on.)"""
    import importlib
    import inspect
    import pkgutil

    import lmsf_slam_tpu_torch as p

    seen = []
    for info in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
        mod = importlib.import_module(info.name)
        members = []
        for _, obj in inspect.getmembers(mod):
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                members.append(obj)
            elif inspect.isclass(obj):
                members += [f for _, f in inspect.getmembers(obj)
                            if inspect.isfunction(f) or inspect.ismethod(f)]
        for fn in members:
            param = inspect.signature(fn).parameters.get("device")
            if param is not None and param.default is not inspect.Parameter.empty:
                seen.append(fn.__qualname__)
                assert param.default == "cuda", (mod.__name__, fn.__qualname__, param.default)
    assert len(seen) >= 14, seen  # MultiLidarSystem, KeyframeDatabase, build_featurize, ...


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(("." * node.level) + (node.module or ""))
    return names


@pytest.mark.parametrize("name", TOOLING_MODULES + SCRIPTS)
def test_tooling_modules_and_scripts_name_no_jax(name):
    """NDT's modules, the KITTI entry point, its tooling and the port's
    scripts: no import statement at any depth (function bodies included)
    names JAX or the reference package; matplotlib only inside a function."""
    if name.endswith(".py"):
        path = ROOT / name
    else:
        path = PACKAGE / (name.replace(".", "/") + ".py")
        if not path.exists():
            path = PACKAGE / name.replace(".", "/") / "__init__.py"
    names = _imports(path)
    assert names and not any(_forbidden(n) for n in names), names
    top = [n for n in ast.parse(path.read_text()).body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("matplotlib" in ast.dump(n) for n in top), name


def test_scripts_import_no_jax_at_run_time():
    code = (
        "import runpy, sys\n"
        f"for s in {SCRIPTS!r}:\n"
        "    sys.argv = [s, '--help']\n"
        "    try:\n"
        "        runpy.run_path(s, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (s, e.code)\n"
        f"bad = sorted(n for n in sys.modules if any(n == f or n.startswith(f + '.') for f in {FORBIDDEN_AT_IMPORT + ('matplotlib',)!r}))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", MESH_MODULES + ("tests/torch_ranks.py",))
def test_mesh_modules_name_no_jax(module):
    """The modules beyond one device and the ranks' test helpers: no import
    statement at any depth names JAX or the reference package, and what they
    import outside this package is the standard library, numpy or torch."""
    path = RANK_HELPERS if module.endswith(".py") else PACKAGE / (module.replace(".", "/") + ".py")
    names = _imports(path)
    assert names and not any(_forbidden(n) for n in names), names
    roots = {n.split(".")[0] for n in names if not n.startswith(".")}
    allowed = {"__future__", "os", "socket", "time", "traceback", "datetime", "typing", "numpy",
               "torch", "lmsf_slam_tpu_torch"}
    assert roots <= allowed, roots


def test_rank_helpers_import_no_jax_at_run_time():
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_ranks\n"
        f"bad = sorted(n for n in sys.modules if any(n == f or n.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
