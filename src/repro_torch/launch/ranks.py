"""Processes of this host as the ranks of one gloo group: what the launchers
that run ranks share (``launch.parallel``, serving; ``launch.train`` with
``--mesh``).

:func:`launch` starts ``world`` processes of a launcher module, ``python -m
MODULE ARGS --rank R --store S --out O``, which meet through a
``FileStore`` in a temporary directory (no TCP port, so launchers running
at once cannot collide), waits for all of them, stopping the others when
one fails, and returns what each saved.  A rank runs inside
:func:`joined`, takes its device from :func:`rank_device`, builds its
blocks through :func:`build_in_turns` and saves its results with
:func:`save`.

On one card every rank runs on it (``cuda`` is device ``rank % count``):
NCCL refuses two ranks on one device, and gloo moves the collectives'
bytes through host memory while the layers stay on the card.  Times taken
so are of ranks sharing one card, not of several cards.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List

TIMEOUT = 600.0     # seconds for all ranks to finish


def add_rank_args(ap: argparse.ArgumentParser) -> None:
    """The hidden arguments :func:`launch` gives each rank."""
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)


def launch(module: str, argv: List[str], world: int, timeout: float = TIMEOUT) -> List[Dict]:
    """Start ``world`` rank processes of ``module`` with the arguments
    ``argv``, wait for all of them, and return each rank's results (what
    :func:`save` wrote); raises if one fails or the ranks outlast
    ``timeout`` seconds (the others are stopped)."""
    import torch
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        out = Path(tmp)
        env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")       # every rank is on this host
        src = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        base = [sys.executable, "-m", module] + list(argv) + [
            "--out", str(out), "--store", str(out / "store")]
        procs = [subprocess.Popen(base + ["--rank", str(r)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        failed = []
        try:
            for r, p in enumerate(procs):
                try:
                    text, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    text, _ = p.communicate()
                    failed.append(f"rank {r} timed out after {timeout:.0f} s")
                if p.returncode:
                    failed.append(f"rank {r} exited {p.returncode}:\n{text[-4000:]}")
                    for q in procs:             # a rank that fails leaves its peers waiting
                        if q.poll() is None:
                            q.kill()
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        if failed:
            raise RuntimeError("ranks failed:\n" + "\n".join(failed))
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@contextlib.contextmanager
def joined(args: argparse.Namespace, world: int):
    """This rank (``args.rank``) in the gloo group of ``world`` ranks that
    meet at ``args.store``, while the block runs; torch keeps to 2 threads
    on the CPU, where the ranks share the host's cores."""
    import torch
    import torch.distributed as dist
    if args.device == "cpu":
        torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(args.store, world), rank=args.rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank_device(name: str, rank: int = 0):
    """The device of ``name`` (``cuda`` unless it says otherwise) for
    ``rank``: card ``rank % count``, made the current one."""
    import torch

    from repro_torch.core.device import resolve_device
    device = resolve_device(name)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def rank_params(model, device, dtype, seed: int = 0, mode: str = "serve"):
    """This rank's blocks of ``model``'s weights from ``seed`` by ``mode``'s
    rules at the ambient mesh (``launch.mesh.build_params``), on
    ``device``: what a serving rank (``launch.parallel``) and a training
    rank (``launch.train``) hold; on the meta device (``launch.rank_cost``)
    shapes alone, drawn from a CPU generator."""
    import torch

    from repro_torch.launch import mesh
    device = torch.device(device)
    generator = torch.Generator("cpu" if device.type == "meta" else device).manual_seed(seed)
    return mesh.build_params(model, generator, dtype, device=device, mode=mode)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def allocated(device) -> int:
    """``torch.cuda.memory_allocated`` after a synchronise; 0 on the CPU."""
    import torch
    sync(device)
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def build_in_turns(device, rank: int, world: int, build: Callable):
    """``build()`` on this rank, where the ranks share a card one after
    another, so that only one rank draws its whole leaves on it at a time
    (a barrier after each turn); the caller first gives every rank its
    CUDA context and its first use of the meta device, which costs seconds
    of imports, all at once.  Returns (what ``build`` returned, the bytes
    it left allocated on the card, its seconds)."""
    import torch
    import torch.distributed as dist
    allocated(device)
    shared = device.type == "cuda" and torch.cuda.device_count() < world
    turns = world if shared else 1
    for turn in range(turns):
        if turn == rank % turns:
            before = allocated(device)
            t0 = time.perf_counter()
            out = build()
            built = allocated(device) - before
            seconds = time.perf_counter() - t0
            if device.type == "cuda":
                torch.cuda.empty_cache()  # the whole leaves' blocks, for the others
        if turns > 1:
            dist.barrier()
    return out, built, seconds


def save(args: argparse.Namespace, res: Dict) -> None:
    """This rank's results, for :func:`launch` to return."""
    import torch
    torch.save(res, Path(args.out) / f"rank{args.rank}.pt")
