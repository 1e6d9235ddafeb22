#!/usr/bin/env python3
"""Time the SSD scan kernel (K3) of one checkout over prefill lengths.

    python3 scripts/time_ssd_lengths.py [--root DIR] [--shapes 1x379 1x512 1x2048 1x8192 4x2048]

Imports ``repro_torch`` from ``DIR/src`` (default: the checkout this script
lies in), builds its kernels there, and times its ``ops.ssd_scan`` at the
mamba2_370m widths (H=32, P=64, N=128, chunk 128, fp32, a carried state) for
each shape BxT: the prefill lengths of one sequence and the training shape
(4 sequences of 2048).  Each is checked against the plain version to 2e-4
first, then timed as 20 calls back to back between CUDA events (``ms``), 20
calls captured in a CUDA graph and replayed 5 times (``graph_ms``), and the
device time of each of its launches (``ssd_fwd_chunk``, ``ssd_fwd_scan``)
from torch.profiler over 20 calls (``launch_ms``).  Two checkouts compare on
one card when both run in one machine, e.g. a parent commit unpacked with
``git archive`` beside the change, in the order parent, change, change,
parent.  Prints the card's name and power limit and one JSON line
``{"root": ..., "ms": {shape: ms}, "graph_ms": {...}, "launch_ms": {...}}``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

LAUNCHES = ("ssd_fwd_chunk", "ssd_fwd_scan")


def events_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, reps=5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def launch_ms(fn, iters=20):
    """Device time a call of each launch, from the profiler's raw events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(LAUNCHES, 0.0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        for name in LAUNCHES:
            if name in e.name():
                out[name] += max(e.duration_ns(), 0) / 1e6 / iters
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--shapes", nargs="+", default=["1x379", "1x512", "1x2048", "1x8192", "4x2048"])
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
    out = {"root": args.root, "ms": {}, "graph_ms": {}, "launch_ms": {}}
    for shape in args.shapes:
        B, T = (int(v) for v in shape.split("x"))
        xdt = torch.randn((B, T, H, P), generator=gen, device="cuda")
        dA = -F.softplus(torch.randn((B, T, H), generator=gen, device="cuda"))
        Bm = torch.randn((B, T, N), generator=gen, device="cuda")
        Cm = torch.randn((B, T, N), generator=gen, device="cuda")
        s0 = torch.randn((B, H, N, P), generator=gen, device="cuda")

        def call():
            return ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0)

        y, st = call()
        y_exp, st_exp = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0, force="plain")
        torch.testing.assert_close(y, y_exp, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(st, st_exp, rtol=2e-4, atol=2e-4)
        out["ms"][shape] = events_ms(call)
        out["graph_ms"][shape] = graph_ms(call)
        out["launch_ms"][shape] = launch_ms(call)
        print(f"{shape}: {out['ms'][shape]:.4f} ms a call, {out['graph_ms'][shape]:.4f} in a graph; "
              + ", ".join(f"{k} {v:.4f}" for k, v in out["launch_ms"][shape].items()), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
