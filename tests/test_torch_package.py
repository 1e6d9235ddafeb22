"""Package rules of the PyTorch port.

* Import guard: ``repro_torch`` and ``chip_smoke.py`` import nothing of JAX
  and nothing of the JAX package ``repro``.
* Drift check: the control-plane modules the port copies from ``repro``
  equal their originals line for line once import lines are normalised, so
  the two copies cannot drift apart unnoticed.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"

COPIES = [
    "models/config.py",
    "configs/__init__.py",
    "configs/dbrx_132b.py",
    "configs/granite_3_8b.py",
    "configs/granite_8b.py",
    "configs/llama3_70b.py",
    "configs/llama3_8b.py",
    "configs/llava_next_mistral_7b.py",
    "configs/mamba2_370m.py",
    "configs/mixtral_8x7b.py",
    "configs/olmo_1b.py",
    "configs/qwen2_5_3b.py",
    "configs/qwen3_30b_a3b.py",
    "configs/recurrentgemma_2b.py",
    "configs/whisper_base.py",
    "core/clock.py",
    "core/hardware.py",
    "core/predictor.py",
    "core/timekeeper.py",
    "core/client.py",
    "core/emulation.py",
    "metrics/__init__.py",
    "metrics/latency.py",
    "metrics/sketch.py",
    "workload/__init__.py",
    "workload/arrival.py",
    "workload/session.py",
    "workload/streaming.py",
    "workload/synth.py",
    "serving/request.py",
    "serving/kv_cache.py",
    "serving/prefix_cache.py",
    "serving/scheduler.py",
    "serving/engine.py",
    "serving/workers.py",
    "serving/benchmark.py",
    # the distributed control plane, in the order each needs the last
    "core/transport.py",
    "core/shm_transport.py",
    "cluster/router.py",
    "cluster/tiers.py",
    "cluster/faults.py",
    "cluster/autoscaler.py",
    "cluster/cluster.py",
    "cluster/process_backend.py",
    "cluster/__init__.py",
    "serving/disagg.py",
    "des/simulator.py",
    "scenario/spec.py",
    "scenario/presets.py",
    "scenario/sweep.py",
    "scenario/runner.py",
    "scenario/__init__.py",
    "scenario/__main__.py",
    "fleet/spec.py",
    "fleet/router.py",
    "fleet/metrics.py",
    "fleet/runner.py",
    "fleet/__init__.py",
]

# copies inside a module the port rewrites in part: (module, top-level name)
COPIED_DEFS = [
    ("serving/model_runner.py", "DUMMY_TOKEN"),
    ("serving/model_runner.py", "batch_spec_of"),
    ("serving/model_runner.py", "_producing"),
    ("serving/model_runner.py", "TimeWarpModelRunner"),
    ("serving/model_runner.py", "SleepModelRunner"),
    ("serving/stack.py", "default_predictor"),
]

GUARD = """
import importlib, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference():
    res = subprocess.run(
        [sys.executable, "-c", GUARD], cwd=REPO, capture_output=True, text=True,
        env={"PYTHONPATH": f"{SRC}:{REPO}", "PYTHONDONTWRITEBYTECODE": "1",
             "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 20   # every module was imported


PORT_FILES = sorted(p.relative_to(REPO).as_posix() for p in
                    [*(SRC / "repro_torch").rglob("*.py"), REPO / "chip_smoke.py"])


@pytest.mark.parametrize("sub", ["cluster", "des", "scenario", "fleet"])
def test_import_guard_walks_the_control_plane(sub):
    """The walk of every file below covers each subpackage of the control
    plane, lazy imports inside functions included."""
    assert any(p.startswith(f"src/repro_torch/{sub}/") for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_statement_names_jax_or_reference(path):
    """Also lazy imports inside functions, which the guard cannot reach."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


NO_TORCH = """
import sys
import repro_torch.cluster, repro_torch.des.simulator, repro_torch.fleet, repro_torch.scenario
from repro_torch.scenario import get_preset, run
for backend in ("thread", "des"):
    assert run(get_preset("distributed_parity"), backend).num_requests > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro"))
assert not bad, bad
"""


def test_control_plane_runs_without_torch():
    """The emulator's control plane runs with no torch loaded, as the
    reference's runs with no JAX: importing the cluster, the DES, the
    scenarios and the fleets and running a scenario on the thread and DES
    backends leaves ``torch`` out of ``sys.modules``.  The process
    backend's replicas import the same modules."""
    res = subprocess.run(
        [sys.executable, "-c", NO_TORCH], cwd=REPO, capture_output=True, text=True,
        env={"PYTHONPATH": str(SRC), "PYTHONDONTWRITEBYTECODE": "1",
             "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert res.returncode == 0, res.stderr


def _normalised(text: str):
    """Lines with the package named ``repro`` in import lines (indented ones
    too: a lazy import inside a function) and in ``importlib`` calls."""
    out = []
    for line in text.splitlines():
        if line.lstrip().startswith(("from ", "import ")) or "import_module(" in line:
            line = line.replace("repro_torch", "repro")
        out.append(line)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_has_not_drifted(rel):
    assert (_normalised((SRC / "repro_torch" / rel).read_text())
            == _normalised((SRC / "repro" / rel).read_text()))


def _definition(path: Path, name: str) -> str:
    text = path.read_text()
    for node in ast.parse(text).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)) and node.name == name:
            return ast.get_source_segment(text, node)
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.get_source_segment(text, node)
    raise AssertionError(f"{path}: no top-level {name}")


@pytest.mark.parametrize("rel,name", COPIED_DEFS)
def test_copied_definition_has_not_drifted(rel, name):
    assert (_normalised(_definition(SRC / "repro_torch" / rel, name))
            == _normalised(_definition(SRC / "repro" / rel, name)))
