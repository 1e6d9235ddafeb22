#!/usr/bin/env python3
"""Time the start of the rank processes that ``launch.parallel`` runs, stage by stage.

    python3 scripts/time_rank_start.py [--ranks 4]

From the root of a checkout, on the card: starts ``--ranks`` processes of
this script at once (as ``launch.ranks`` starts the ranks of a launcher,
all sharing the one card), each of which prints the seconds since it
started at each stage of a serving rank's start: numpy, ``import torch``,
the CUDA context, the port's imports, the gloo group (a ``FileStore`` in a
temporary directory), the ("data", "model") device mesh of (2, ranks / 2),
qwen2_5_3b's tree at full width (2 layers) on the meta device, its blocks
drawn on the card (``mesh.build_params``), the kernels loaded, one prefill
of 4 rows of 64 tokens and 2 decodes (``launch.parallel._serve``), a
barrier.  The stages' times say where a rank launch spends the seconds
before any work.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def stage(rank, what):
    print(f"[rank {rank}] {time.perf_counter() - T0:7.2f} s {what}", flush=True)


def rank_main(rank: int, world: int, store: str) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy  # noqa: F401
    stage(rank, "numpy")
    import torch
    stage(rank, "import torch")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    stage(rank, "CUDA context")
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch import mesh, parallel
    from repro_torch.models.transformer import build_model
    stage(rank, "the port's imports")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    stage(rank, "gloo group")
    dm = mesh.device_mesh(mesh.MeshAxes(("data", "model"), (2, world // 2)), "cuda")
    stage(rank, "device mesh")
    args = parallel.parse_args(["--arch", "qwen2_5_3b", "--layers", "2", "--mesh",
                                f"2,{world // 2}", "--batch", "4", "--prompt", "64",
                                "--decodes", "2"])
    device = torch.device("cuda")
    with mesh.use_mesh(dm):
        model = build_model(parallel.model_config(args))
        model.init(torch.Generator().manual_seed(0), torch.bfloat16, device="meta")
        stage(rank, "meta tree")
        params = mesh.build_params(model, torch.Generator(device).manual_seed(0), torch.bfloat16)
        torch.cuda.synchronize()
        stage(rank, "blocks drawn")
        _build.build(("flash_attention", "paged_attention"))
        stage(rank, "kernels loaded")
        parallel._serve(args, lambda cf: parallel.model_config(args, "ragged", cf), params,
                        device, torch.bfloat16, mesh.batch_rows(args.batch), warm=False)
        stage(rank, "served")
    dist.barrier()
    stage(rank, "barrier")
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank >= 0:
        rank_main(args.rank, args.ranks, args.store)
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    _build.build(("flash_attention", "paged_attention"))       # once, before the ranks
    with tempfile.TemporaryDirectory(prefix="rank-start-") as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, __file__, "--ranks", str(args.ranks),
                                   "--rank", str(r), "--store", str(Path(tmp) / "store")],
                                  env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
                 for r in range(args.ranks)]
        codes = [p.wait() for p in procs]
        print(f"{args.ranks} ranks: {time.perf_counter() - t0:.2f} s, exit codes {codes}",
              flush=True)
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
