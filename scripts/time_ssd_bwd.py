#!/usr/bin/env python3
"""Time the gradient of the SSD scan kernel (K3-bwd) of one checkout.

    python3 scripts/time_ssd_bwd.py [--root DIR] [--shapes 4x2048 1x512 1x8192] [--one-group]

Imports ``repro_torch`` from ``DIR/src`` (default: the checkout this script
lies in), builds its kernels there, and times its
``kernels.ssd_scan_bwd.ssd_scan_bwd`` at mamba2_370m's widths (H=32, P=64,
N=128, chunk 128, fp32, no initial state, as training calls it) for each
``BxT`` shape: the training shape 4x2048 and single sequences of 512 and
8192 tokens by default.  Each shape is first checked against the plain
decomposition (``ref.ssd_scan_bwd_two_pass``, 1e-4 of each gradient's
largest entry), then timed as 20 calls back to back between CUDA events and
as 20 calls replayed from a CUDA graph, with the device time of each launch
from ``torch.profiler``.  Two checkouts compare on one card when both run
in one machine, e.g. a parent commit unpacked with ``git archive`` beside
the change, in the order parent, change, change, parent.  ``--one-group``
keeps every head in one group of ``ssd_bwd_bc`` (``ssd_scan_bwd.plan``
otherwise cuts the heads into groups where the sequences' chunks alone
leave SMs idle), to time the plan's groups against one.  Prints the card's
name and power limit and one JSON line ``{"root": ..., "shapes": {...}}``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

H, P, N, Q = 32, 64, 128, 128


def events_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, reps=5):
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def launch_ms(fn, iters=20):
    """Device time per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        name = re.search(r"ssd_bwd_\w+", evt.key)
        if evt.device_type == torch.autograd.DeviceType.CUDA and name:
            out[name.group(0)] = (out.get(name.group(0), 0.0)
                                  + evt.self_device_time_total / 1e3 / iters)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--shapes", nargs="+", default=["4x2048", "1x512", "1x8192"])
    ap.add_argument("--one-group", action="store_true",
                    help="every head in one group of ssd_bwd_bc, whatever the plan would cut")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.dont_write_bytecode = True
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.kernels import ssd_scan_bwd as bwd_mod
    if args.one_group:
        if not hasattr(bwd_mod, "SMS"):
            print(f"{args.root}: its K3-bwd cuts no head groups", file=sys.stderr)
            return 1
        bwd_mod.SMS = 0     # plan: max(1, min(H, 0 // blocks)) groups of H heads: one

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(41)
    out = {}
    for shape in args.shapes:
        B, T = (int(v) for v in shape.split("x"))
        xs = [torch.randn((B, T, H, P), generator=gen, device="cuda"),
              -F.softplus(torch.randn((B, T, H), generator=gen, device="cuda")),
              torch.randn((B, T, N), generator=gen, device="cuda"),
              torch.randn((B, T, N), generator=gen, device="cuda")]
        dy = torch.randn((B, T, H, P), generator=gen, device="cuda")
        _, state, carry = ssd_mod.ssd_scan(*xs, chunk=Q)

        def call():
            return bwd_mod.ssd_scan_bwd(*xs, dy, carry, state, chunk=Q)

        got = call()[:4]
        exp = ref.ssd_scan_bwd_two_pass(*xs, dy, chunk=Q)[:4]
        torch.cuda.synchronize()
        err = max(float((g - e).abs().max()) / float(e.abs().max()) for g, e in zip(got, exp))
        if not err <= 1e-4:
            print(f"{shape}: gradients off by {err:.3e} of the largest entry", flush=True)
            return 1
        res = {"ms": events_ms(call), "graph_ms": graph_ms(call), "launch_ms": launch_ms(call),
               "max_err_rel": err}
        res["groups"] = bwd_mod.plan(B, T, H, P, N, Q).groups if hasattr(bwd_mod, "plan") else None
        out[shape] = res
        launches = ", ".join(f"{k} {v:.4f}" for k, v in res["launch_ms"].items())
        print(f"B={B} T={T} ({res['groups']} head groups): {res['ms']:.4f} ms back to back, "
              f"{res['graph_ms']:.4f} ms in a graph; a launch: {launches}; error {err:.3e}",
              flush=True)
    print(json.dumps({"root": args.root, "one_group": args.one_group, "card": smi,
                      "shapes": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
