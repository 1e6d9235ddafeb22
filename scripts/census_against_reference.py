"""The port's census of dry-run cells beside the reference's, on the CPU.

    PYTHONPATH=src python scripts/census_against_reference.py
    PYTHONPATH=src python scripts/census_against_reference.py \\
        --cell llama3_8b/decode_32k --cell mixtral_8x7b/decode_32k/moe_a2a

    PYTHONPATH=src python scripts/census_against_reference.py --by-op 6 \\
        --cell qwen2_5_3b/train_4k

For each cell (arch/shape[/opt...]) at the (16, 16) production mesh it
prints one markdown row: the per-device product FLOPs and the collective
result bytes by kind and ops of the port (``repro_torch.launch.rank_cost``,
the sampled rank with the most FLOPs) beside the reference's
(``repro.launch.hlo_cost.analyze_hlo`` of the cell compiled for its mesh,
products alone: its elementwise and reduction terms set to 0).  The
reference runs in a subprocess of its own (JAX on 512 host devices,
``PYTHONDONTWRITEBYTECODE=1``); this process imports torch and the port
only.  The default cells are the five of ``PERF.md`` §6.  ``--by-op N``
also prints, for each cell, the reference's N largest product FLOPs and
collective bytes by the op that makes them (its HLO metadata's
``op_name``, weighted by the loops' trip counts as ``analyze_hlo``
weights them): where the reference's work lies.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

REPO = Path(__file__).resolve().parent.parent
CELLS = ["llama3_8b/decode_32k", "whisper_base/decode_32k", "qwen2_5_3b/train_4k",
         "mixtral_8x7b/decode_32k/moe_a2a", "qwen2_5_3b/decode_32k/kv_seq_shard"]
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
SHORT = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS", "all-to-all": "A2A",
         "collective-permute": "CP"}

REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import collections, json, re, sys
import jax
from repro.launch import hlo_cost
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import build_cell

# products alone, as the port counts them: no elementwise or reduction term
hlo_cost._ELEMENTWISE = frozenset()
hlo_cost._operand_bytes = lambda op, comp: 0.0
H = hlo_cost


def by_op(text):
    # {"dot flops" and each collective kind: [(op_name, weighted total)]}
    comps, entry = H._parse_module(text)
    acc = collections.defaultdict(collections.Counter)
    name_re = re.compile(r'op_name="([^"]*)"')

    def walk(name, mult, seen=()):
        comp = comps.get(name)
        if comp is None or name in seen:
            return
        for op in comp.ops:
            if op.kind == "while":
                trips = H._TRIP_RE.search(op.rest)
                body = H._CALLS_RE.search(op.rest)
                if body:
                    walk(body.group(1), mult * (int(trips.group(1)) if trips else 1),
                         seen + (name,))
                continue
            if op.kind in ("fusion", "call", "conditional", "async-start"):
                callee = H._CALLS_RE.search(op.rest)
                if callee:
                    walk(callee.group(1), mult, seen + (name,))
                continue
            found = name_re.search(op.rest)
            where = found.group(1) if found else "?"
            base = op.kind[:-len("-start")] if op.kind.endswith("-start") else op.kind
            if op.kind == "dot":
                acc["dot flops"][where] += mult * H._dot_flops(op, comp)
            elif base in H._COLLECTIVES:
                acc[base][where] += mult * H._nbytes(op.out_shapes)

    walk(entry, 1.0)
    return {k: v.most_common() for k, v in acc.items()}


out = {}
for cell in json.loads(sys.argv[1]):
    arch, shape, *opts = cell.split("/")
    mesh = make_production_mesh()
    built = build_cell(arch, shape, mesh, opts=tuple(opts))
    with mesh:
        text = jax.jit(built.fn, in_shardings=built.in_shardings,
                       donate_argnums=built.donate_argnums).lower(*built.args).compile().as_text()
    cost = hlo_cost.analyze_hlo(text)
    out[cell] = {"flops": cost.flops, "bytes_by_op": cost.collective_bytes_by_op,
                 "total_ops": cost.collective_ops, "by_op": by_op(text)}
print(json.dumps(out))
"""


def reference(cells: Sequence[str]) -> Dict[str, Dict]:
    """{cell: the reference's per-device "flops", "bytes_by_op", "total_ops"}
    at (16, 16), from a JAX subprocess."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(list(cells))],
                          capture_output=True, text=True, timeout=1200, env=env, cwd=REPO)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    return json.loads(proc.stdout.splitlines()[-1])


def port(cells: Sequence[str]) -> Dict[str, Dict]:
    """{cell: ``rank_cost.cell_census``} at (16, 16)."""
    from repro_torch.launch import dryrun, rank_cost, specs
    out = {}
    for cell in cells:
        arch, shape, *opts = cell.split("/")
        out[cell] = rank_cost.cell_census(specs.build_cell(arch, shape,
                                                           dryrun.production_axes(False),
                                                           tuple(opts)))
    return out


def rows(cells: Sequence[str], ours: Dict, theirs: Dict) -> List[str]:
    out = ["| cell | FLOPs a device, port / reference (ratio) | result bytes by kind, port / "
           "reference | ops, port / reference |", "|---|---|---|---|"]
    for cell in cells:
        top = max(ours[cell]["ranks"], key=lambda r: r["flops"])
        ref = theirs[cell]
        flops = f"{top['flops']:,} / {int(ref['flops']):,} ({top['flops'] / ref['flops']:.3f})"
        kinds = "; ".join(f"{SHORT[k]} {top['bytes_by_op'][k]:,} / {int(ref['bytes_by_op'][k]):,}"
                          for k in KINDS if top["bytes_by_op"][k] or ref["bytes_by_op"][k])
        out.append(f"| {cell} | {flops} | {kinds} | {top['total_ops']} / {ref['total_ops']} |")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", action="append", default=[], metavar="ARCH/SHAPE[/OPT]")
    ap.add_argument("--by-op", type=int, default=0, metavar="N",
                    help="also the reference's N largest FLOPs and bytes by op")
    args = ap.parse_args(argv)
    cells: Tuple[str, ...] = tuple(args.cell or CELLS)
    theirs = reference(cells)
    for line in rows(cells, port(cells), theirs):
        print(line)
    for cell in cells if args.by_op else ():
        for what, ranked in theirs[cell]["by_op"].items():
            total = sum(v for _, v in ranked)
            for where, v in ranked[:args.by_op]:
                print(f"{cell} reference {what}: {v:.4e} of {total:.4e} ({v / total:.3f}) {where}")


if __name__ == "__main__":
    main()
