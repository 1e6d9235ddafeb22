"""Build and load the CUDA kernels of :mod:`repro_torch.kernels`.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so``, compiled by ``nvcc`` for
``sm_90a`` with a plain C interface and loaded with :mod:`ctypes`.  Builds go
to ``build/kernels/<hash>/`` at the repository root, where the hash covers
every source in ``csrc/`` and the compiler flags, so an edit to any source
rebuilds everything and a stale library is never loaded.  Nothing is built
when a module is imported: the first launch of a kernel builds it, or a
caller builds them all at once with :func:`build` (one ``nvcc`` process per
source, all started together).  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
KERNELS = ("flash_attention", "flash_attention_bwd", "paged_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}      # kernel name -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_dir() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return REPO_ROOT / "build" / "kernels" / h.hexdigest()[:16]


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every library in ``names`` that is not built yet, all in
    parallel, and load them.  Returns the seconds spent."""
    t0 = time.monotonic()
    with _lock:
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            if name in _libs:
                continue
            lib = out_dir / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = _libs[name]
    return lib
