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
    "configs/llama3_8b.py",
    "configs/granite_8b.py",
    "configs/qwen2_5_3b.py",
    "configs/mamba2_370m.py",
    "core/clock.py",
    "serving/request.py",
    "serving/kv_cache.py",
    "serving/prefix_cache.py",
    "serving/scheduler.py",
    "serving/engine.py",
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


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix() for p in
                                        [*(SRC / "repro_torch").rglob("*.py"),
                                         REPO / "chip_smoke.py"]))
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


def _normalised(path: Path):
    out = []
    for line in path.read_text().splitlines():
        if line.startswith(("from ", "import ")):
            line = line.replace("repro_torch", "repro")
        out.append(line)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_has_not_drifted(rel):
    assert _normalised(SRC / "repro_torch" / rel) == _normalised(SRC / "repro" / rel)
