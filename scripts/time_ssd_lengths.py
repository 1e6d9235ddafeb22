#!/usr/bin/env python3
"""Time the SSD scan kernel (K3) of one checkout over prefill lengths.

    python3 scripts/time_ssd_lengths.py [--root DIR] [--lengths 379 512 2048 8192]

Imports ``repro_torch`` from ``DIR/src`` (default: the checkout this script
lies in), builds its kernels there, and times its ``ops.ssd_scan`` at the
mamba2_370m prefill widths (B=1, H=32, P=64, N=128, chunk 128, fp32, a
carried state) for each length: 20 calls back to back between CUDA events,
after checking the result against the plain version to 2e-4.  Two
checkouts compare on one card when both run in one machine, e.g. a parent
commit unpacked with ``git archive`` beside the change, in the order
parent, change, change, parent.  Prints the card's name and power limit and
one JSON line ``{"root": ..., "ms": {T: ms}}``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--lengths", type=int, nargs="+", default=[379, 512, 2048, 8192])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.dont_write_bytecode = True
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    H, P, N, Q = 32, 64, 128, 128
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for T in args.lengths:
        xdt = torch.randn((1, T, H, P), generator=gen, device="cuda")
        dA = -F.softplus(torch.randn((1, T, H), generator=gen, device="cuda"))
        Bm = torch.randn((1, T, N), generator=gen, device="cuda")
        Cm = torch.randn((1, T, N), generator=gen, device="cuda")
        s0 = torch.randn((1, H, N, P), generator=gen, device="cuda")

        def call():
            return ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0)

        y, st = call()
        y_exp, st_exp = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0, force="plain")
        torch.testing.assert_close(y, y_exp, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(st, st_exp, rtol=2e-4, atol=2e-4)
        for _ in range(3):
            call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        out[T] = start.elapsed_time(end) / 20
        print(f"T={T}: {out[T]:.4f} ms a call", flush=True)
    print(json.dumps({"root": args.root, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
