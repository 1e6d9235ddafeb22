#!/usr/bin/env python3
"""Time the flash attention kernel (K1) of one checkout at the llama3_8b shapes.

    python3 scripts/time_flash_shapes.py [--root DIR] [--tiles ROWSxKEYS]

Imports ``repro_torch`` from ``DIR/src`` (default: the checkout this script
lies in), builds its kernels there, and times its ``ops.flash_attention``
in bf16 at the llama3_8b widths (32 query and 8 KV heads of 128): at the
timed shape of ``chip_smoke.py`` (T=512 after 512 cached tokens), at the
(T, S) pairs that ``chip_smoke.py``'s llama3_8b serving run launches K1
with (phase 5 logs them), and at G=8 (qwen2_5_3b's 16 query and 2 KV
heads) at the timed T and S.  At each shape it first holds the result to
2e-2 against the plain version, then times 20 calls back to back between
CUDA events, 20 calls captured in a CUDA graph and replayed (the host out
of the way), the host's µs to issue one call, and
``scaled_dot_product_attention`` on the same inputs both ways (KV heads
repeated and laid out (B, H, S, D) beforehand, never used by the port).
``--tiles`` fixes the bf16 kernel's tiles (block rows x keys) for a
checkout whose wrapper has ``plan``.  Two checkouts compare on one card when
both run in one machine, e.g. a parent commit unpacked with ``git archive``
beside the change, in the order parent, change, change, parent.  Prints
the card's name and power limit and one JSON line
``{"root": ..., "tiles": ..., "shapes": {label: {...}}}``.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

# (T, S) of each K1 launch in chip_smoke.py's llama3_8b serving run (phase 5)
SERVING = [(11, 11), (49, 164), (55, 699), (115, 115), (130, 586), (133, 133), (142, 142),
           (195, 195), (369, 369), (379, 891), (393, 404), (456, 456), (511, 644), (512, 512)]


def events_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    return events_ms(graph.replay, iters=reps, warmup=1) / iters


def host_us(fn, n=200) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tiles", default=None, help="ROWSxKEYS, e.g. 128x64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.dont_write_bytecode = True
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops

    if args.tiles:
        rows, keys = (int(x) for x in args.tiles.split("x"))
        flash_mod.plan = functools.partial(flash_mod.plan, block_rows=rows, block_keys=keys)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    shapes = [("timed", 512, 1024, 32, 8), ("G=8", 512, 1024, 16, 2)]
    shapes += [(f"serving T={T} S={S}", T, S, 32, 8) for T, S in SERVING]
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for label, T, S, Hq, Hkv in shapes:
        D = 128
        q = torch.randn((1, T, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((1, S, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((1, S, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)

        def call():
            return ops.flash_attention(q, k, v)

        torch.testing.assert_close(call().float(),
                                   ops.flash_attention(q, k, v, force="plain").float(),
                                   rtol=2e-2, atol=2e-2)
        qh = q.transpose(1, 2).contiguous()
        kh = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
        vh = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
        mask = torch.arange(S, device="cuda")[None, :] <= torch.arange(T, device="cuda")[:, None] + (S - T)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

        res = {"ms": events_ms(call), "graph_ms": graph_ms(call), "host_us": host_us(call),
               "library_ms": events_ms(sdpa), "library_graph_ms": graph_ms(sdpa)}
        out[label] = res
        print(f"{label}: kernel {res['ms']:.4f} ms ({res['graph_ms']:.4f} in a graph), host "
              f"{res['host_us']:.1f} us a call; SDPA {res['library_ms']:.4f} ms "
              f"({res['library_graph_ms']:.4f} in a graph)", flush=True)
    print(json.dumps({"root": args.root, "tiles": args.tiles, "shapes": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
