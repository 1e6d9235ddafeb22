#!/usr/bin/env python3
"""What K3's forward products cost, and how ptxas compiled them, on one card.

    python3 scripts/time_ssd_products.py [--root DIR]

From the checkout at DIR (default: the one this script lies in) it builds
the checkout's library and, beside it in ``build/ssd_products/``, two copies
of ``csrc/ssd_scan.cu`` (nvcc with ``_build.NVCC_FLAGS``, all started
together):

* ``no_mma``: ``ssd_fwd_scan``'s products skipped (its y is wrong);
* ``one_pass``: ``ssd_fwd_scan``'s products on big·big alone (y is off by
  TF32's rounding).

It times each launch of the three libraries (device time from
torch.profiler over 20 calls, ``time_ssd_lengths.launch_ms``) at
mamba2_370m's widths (H=32, P=64, N=128, chunk 128, fp32, a carried state)
for 1x512 and 4x2048: what the scan launch takes without its products, and
with a third of them.  Then it reads the checkout's SASS (``cuobjdump
-sass``) of each K3 forward instantiation and counts its ``HMMA``
instructions, its ``WARPSYNC`` instructions, and the ``HMMA`` that stand,
in the listing's order, between a ``BSSY`` and its ``BSYNC`` (code that
ptxas reconverges after a divergent branch) or under a predicate.  Prints
the card's name and power limit and one JSON line.  Needs a CUDA device;
the two anchors below must match the source.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

from time_ssd_lengths import launch_ms

MMA_CALL = "    strips_mma<NT>(acc, two ? k_lo : 0, active ? k_hi : 0,"
ALL_PASSES = "    for (int p = 0; p < MF::kPasses; ++p) {\n#pragma unroll\n      for (int j = 0; j < NT; ++j)"
# the instantiations as ptxas and cuobjdump name them
KERNELS = {f"{k}<{tn},{pt}>": f"{k}I{mangled}Li{pt}E"
           for k in ("ssd_fwd_chunk", "ssd_fwd_scan")
           for tn, mangled in (("float", "f"), ("bf16", "13__nv_bfloat16")) for pt in (16, 32, 64)}


def variants(src):
    """The two copies: the scan's one call of strips_mma skipped, and both
    of strips_mma's pass loops started at the last pass (big·big)."""
    for anchor, times in ((MMA_CALL, 1), (ALL_PASSES, 2)):
        if src.count(anchor) != times:
            raise SystemExit(f"anchor not {times} times in ssd_scan.cu (update this script): "
                             f"{anchor[:60]!r}")
    return {"no_mma": src.replace(MMA_CALL, "    if (n_sl < 0)\n" + MMA_CALL),
            "one_pass": src.replace(ALL_PASSES, ALL_PASSES.replace("int p = 0", "int p = 2"))}


def sass_census(listing):
    """{instantiation: counts} from ``cuobjdump -sass`` output."""
    out = {}
    for block in listing.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        label = next((k for k, m in KERNELS.items() if m in name), None)
        if label is None:
            continue
        counts = dict(hmma=0, warpsync=0, bssy=0, hmma_reconverged=0, hmma_predicated=0)
        open_barriers = set()
        for line in block.splitlines():
            ins = re.search(r"\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*(B\d+)?", line)
            if not ins:
                continue
            op = ins.group(2)
            if op.startswith("BSSY"):
                counts["bssy"] += 1
                open_barriers.add(ins.group(3))
            elif op.startswith("BSYNC"):
                open_barriers.discard(ins.group(3))
            elif op.startswith("WARPSYNC"):
                counts["warpsync"] += 1
            elif op.startswith("HMMA"):
                counts["hmma"] += 1
                counts["hmma_reconverged"] += bool(open_barriers)
                counts["hmma_predicated"] += bool(ins.group(1))
        out[label] = counts
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.dont_write_bytecode = True
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out_dir = root / "build" / "ssd_products"
    procs = {}
    for name, text in variants((_build.CSRC / "ssd_scan.cu").read_text()).items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "ssd_scan.cu").write_text(text)
        for header in ("ssd_tile.cuh", "mma.cuh", "common.cuh"):
            (d / header).write_text((_build.CSRC / header).read_text())
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "ssd_scan.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    _build.build(("ssd_scan",))
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            return 1
    libs = {"kernel": _build.load("ssd_scan")}
    libs.update({name: ctypes.CDLL(str(out_dir / name / "lib.so")) for name in procs})
    argtypes = ssd_mod._kernel().argtypes
    H, P, N, Q = 32, 64, 128, 128
    gen = torch.Generator(device="cuda").manual_seed(6)
    result = {"card": smi, "launch_ms": {}}
    for B, T in ((1, 512), (4, 2048)):
        xdt = torch.randn((B, T, H, P), generator=gen, device="cuda")
        dA = -F.softplus(torch.randn((B, T, H), generator=gen, device="cuda"))
        Bm = torch.randn((B, T, N), generator=gen, device="cuda")
        Cm = torch.randn((B, T, N), generator=gen, device="cuda")
        s0 = torch.randn((B, H, N, P), generator=gen, device="cuda")
        for name, lib in libs.items():
            fn = lib.ssd_scan_fwd
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            with mock.patch.object(ssd_mod, "_kernel", lambda fn=fn: fn):
                ms = launch_ms(lambda: ssd_mod.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0))
            result["launch_ms"][f"{name} {B}x{T}"] = ms
            print(f"{name} {B}x{T}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()),
                  flush=True)
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    listing = subprocess.run([cuobjdump, "-sass", str(_build.build_dir() / "libssd_scan.so")],
                             capture_output=True, text=True, check=True).stdout
    result["sass"] = sass_census(listing)
    for label, counts in result["sass"].items():
        print(f"SASS {label}: {counts}", flush=True)
    if len(result["sass"]) != len(KERNELS):
        print(f"SASS: found {sorted(result['sass'])} of {sorted(KERNELS)}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
