"""The dry-run on the meta device: ``repro.launch.dryrun`` without JAX.

For each (architecture × shape × mesh) cell it builds the full config's
trees on the ``meta`` device (:mod:`repro_torch.launch.specs`), runs the
cell's entry once on them under a product FLOP counter
(:func:`flop_counter`: ``torch.utils.flop_counter.FlopCounterMode``'s count),
then each sampled rank's program (:mod:`repro_torch.launch.rank_cost`), and
appends one JSONL record with the reference's keys:

* ``memory.argument_bytes`` — per device, exactly: each argument leaf's
  shard, its shape divided by the mesh sizes of the axes its placement
  names (``mesh.shard_shape``, JAX's ``NamedSharding.shard_shape``), times
  its element size, summed;
* ``memory.output_bytes`` — per device, exactly, from the entry's outputs
  and their placements (the trees it updates in place keep their
  arguments' placements; logits as ``specs.logits_spec``; metrics
  replicated);
* ``cost.flops_program`` — the FLOPs of one run of the entry over the
  whole program, on one device: ``FlopCounterMode`` counts the products
  (``mm``, ``bmm``, ``addmm``, convolutions, attention) and every iteration
  of every Python loop (layers, microbatches, loss chunks, scan chunks),
  and nothing else; the grouped product of the MoE has no formula of its
  own and gets :func:`grouped_mm_flops` (2·rows·k·n);
* ``cost.flops`` and ``collectives`` — per device, from one rank's program
  (:mod:`repro_torch.launch.rank_cost`, the port's ``hlo_cost``): the
  rank's blocks on the meta device, run in a stand-in process group of the
  mesh's size, its product FLOPs and every collective it issues, by
  ``hlo_cost``'s five kinds (``bytes_by_op``: each op's result bytes;
  ``total_bytes``, ``total_ops``: one op a call), of the sampled rank with
  the most FLOPs (the rank at 0 on every axis, and at each axis's last
  coordinate); ``ranks`` gives each sampled rank's coordinates, FLOPs and
  census;
* ``model_params`` and ``model_active_params`` — from the config;
* ``lower_s`` — the seconds to build the cell's meta trees, ``compile_s``
  the seconds of the one-device meta run, ``census_s`` those of the ranks'.

Fields without a counterpart are written as null, under the reference's
keys, and ``null_fields`` gives each one's reason: ``temp_bytes``,
``alias_bytes`` and ``peak_per_device`` (no compiler memory analysis: torch
allocates as it goes), ``bytes_accessed`` (no HLO; on the meta device the
plain versions of the kernels run, whose intermediates are not what the
kernels move), ``xla_cost`` and ``collectives_flat`` (no HLO), and the
census's ``while_loops`` and ``unknown_trip_loops`` (an eager program has
no loops to weight: the FLOP counter and the recorder see every
iteration as it runs).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_5_3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral_8x7b \\
        --shape decode_32k --opt moe_a2a
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

``--all`` runs each cell in a subprocess, so that one failure does not end
the sweep.  Nothing here needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Tuple

DEFAULT_OUT = "build/dryrun/dryrun.jsonl"

NULL_FIELDS = {
    "memory.temp_bytes": "no compiler memory analysis: torch allocates as the program runs",
    "memory.alias_bytes": "no compiler memory analysis (no donation or buffer aliasing)",
    "memory.peak_per_device": "argument bytes plus temp bytes, and temp bytes have no counterpart",
    "cost.bytes_accessed": "no HLO: the traffic of each fused op is not known without a "
                           "compiler, and on the meta device the plain versions of the kernels "
                           "run, whose intermediates are not what the kernels move",
    "collectives.while_loops": "an eager program has no loops to weight: FlopCounterMode and the "
                               "collective recorder see every iteration as it runs",
    "collectives.unknown_trip_loops": "an eager program has no loops to weight: FlopCounterMode "
                                      "and the collective recorder see every iteration as it runs",
    "xla_cost": "no XLA: FlopCounterMode already counts every loop iteration",
    "collectives_flat": "no HLO to parse",
}


def production_axes(multi_pod: bool):
    """The reference's production mesh as axis names and sizes: (16, 16)
    ("data", "model"), or (2, 16, 16) with "pod" first."""
    from .mesh import MeshAxes
    if multi_pod:
        return MeshAxes(("pod", "data", "model"), (2, 16, 16))
    return MeshAxes(("data", "model"), (16, 16))


def grouped_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """FLOPs of ``torch._grouped_mm(a, b, offs)``: every row of the
    products, 2·m·k·n over the groups together (rows past the last offset
    are counted too; the dropless MoE has none)."""
    if len(a_shape) == 2 and len(b_shape) == 3:      # (m, k) by each group's (k, n)
        return 2 * a_shape[0] * a_shape[1] * b_shape[2]
    if len(a_shape) == 2 and len(b_shape) == 2:      # (k, m) by (m, n), groups on m
        return 2 * a_shape[0] * a_shape[1] * b_shape[1]
    if len(a_shape) == 3 and len(b_shape) == 2:      # each group's (m, k) by (k, n)
        return 2 * a_shape[0] * a_shape[1] * a_shape[2] * b_shape[1]
    return 2 * a_shape[0] * a_shape[1] * a_shape[2] * b_shape[2]


def flop_counter():
    """A counter of product FLOPs for a ``with`` block (``get_total_flops()``
    after it): ``FlopCounterMode``'s count, with :func:`grouped_mm_flops`
    for the grouped product, which it otherwise counts as 0
    (``rank_cost.ProductCounter``)."""
    from .rank_cost import ProductCounter
    return ProductCounter()


def _mesh_tag(axes) -> str:
    return "x".join(str(axes.sizes[a]) for a in axes.names)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_path: str,
             verbose: bool = True, opts: Tuple[str, ...] = ()) -> dict:
    """Build the cell, run its entry once on the meta device, and append
    its record to ``out_path`` (if given)."""
    from .mesh import shard_bytes
    from .rank_cost import cell_census
    from .specs import build_cell

    axes = production_axes(multi_pod)
    t0 = time.time()
    cell = build_cell(arch, shape_name, axes, opts=opts)
    t_build = time.time() - t0
    t0 = time.time()
    with flop_counter() as counter:
        outputs = cell.run()
    t_run = time.time() - t0
    flops = counter.get_total_flops()
    t0 = time.time()
    census = cell_census(cell)
    t_census = time.time() - t0

    chips = 1
    for a in axes.names:
        chips *= axes.sizes[a]
    arg_bytes = sum(shard_bytes(a, s, axes) for a, s in zip(cell.args, cell.arg_specs))
    out_bytes = sum(shard_bytes(o, s, axes) for o, s in zip(outputs, cell.out_specs(outputs)))
    record = {
        "arch": arch,
        "shape": shape_name,
        "opts": sorted(cell.opts),
        "entry": cell.entry,
        "mesh": _mesh_tag(axes),
        "axes": list(axes.names),
        "chips": chips,
        "tokens_per_step": cell.tokens_per_step,
        "model_params": cell.model_cfg.param_count(),
        "model_active_params": cell.model_cfg.active_param_count(),
        "lower_s": round(t_build, 2),
        "compile_s": round(t_run, 2),
        "census_s": round(t_census, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "alias_bytes": None,
            "peak_per_device": None,
        },
        "cost": {
            "flops": census["flops"],        # the sampled rank's with the most
            "flops_program": flops,
            "bytes_accessed": None,
        },
        "collectives": dict(census["collectives"], while_loops=None, unknown_trip_loops=None),
        "ranks": census["ranks"],
        "xla_cost": {"flops": None, "bytes_accessed": None},
        "collectives_flat": {"bytes_by_op": None, "counts_by_op": None, "total_bytes": None,
                             "total_ops": None},
        "null_fields": NULL_FIELDS,
        "device": "meta",
    }
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(record) + "\n")
    if verbose:
        print(json.dumps({k: record[k] for k in ("arch", "shape", "mesh", "compile_s",
                                                 "census_s")}
                         | {"argument_bytes": arg_bytes, "flops": flops,
                            "flops_per_device": census["flops"],
                            "collective_bytes": census["collectives"]["bytes_by_op"]}))
    return record


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma-separated knobs (see specs.build_cell)")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape) cell")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    opts = tuple(o for o in args.opt.split(",") if o)
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        run_cell(args.arch, args.shape, args.multi_pod, args.out, opts=opts)
        return

    # sweep: one subprocess per cell, so a failure does not end it
    from repro_torch.configs import all_cells
    done = set()
    if args.skip_existing and Path(args.out).exists():
        for line in Path(args.out).read_text().splitlines():
            r = json.loads(line)
            done.add((r["arch"], r["shape"], r["mesh"]))
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    cells = all_cells()
    failures = []
    for i, (arch, shape) in enumerate(cells):
        if (arch, shape, mesh_tag) in done:
            print(f"[{i+1}/{len(cells)}] {arch} x {shape} — cached")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", args.out]
        if args.multi_pod:
            cmd.append("--multi-pod")
        if args.opt:
            cmd += ["--opt", args.opt]
        print(f"[{i+1}/{len(cells)}] {arch} x {shape} ({mesh_tag}) ...", flush=True)
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failures.append((arch, shape))
            print(f"  FAILED ({time.time()-t0:.0f}s):\n{proc.stderr[-2000:]}")
        else:
            print(f"  ok ({time.time()-t0:.0f}s)")
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print(f"all {len(cells)} cells passed on {mesh_tag}")


if __name__ == "__main__":
    main()
