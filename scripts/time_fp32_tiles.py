#!/usr/bin/env python3
"""Time K1's fp32 forward and K1-bwd over their tile choices on one card.

    python3 scripts/time_fp32_tiles.py [--out FILE]

From the root of a checkout: builds, beside the checkout's own kernels, one
copy of ``csrc/flash_attention.cu`` or ``csrc/flash_attention_bwd.cu`` for
each tile choice below, with the one tile line of the source changed
(``launch_f32<D, BK>`` for the forward; ``BwdTiles<T, 128>`` for the
backward), all nvcc processes started together, into ``build/tiles/``.
For each variant it points the wrapper at that library and at the same
tiles (``flash_attention.F32_KEYS``, ``flash_attention_bwd.TILES``), holds
the result against the plain version (2e-4 forward; 1e-3 fp32 and 2e-2
bf16 of the largest gradient entry backward), and times 20 calls back to
back between CUDA events and 20 calls replayed from a CUDA graph (SDPA's
backward, its forward and backward less its forward, back to back only):

* K1-bwd at qwen2_5_3b's training shape (B=4, T=S=512, 16 query and 2 KV
  heads of 128, causal), fp32 and bf16, over (query rows a dK/dV stage,
  warps sharing 16 keys, keys a dQ stage);
* K1's fp32 forward at the same shape over the key tile at D = 128, and at
  recurrentgemma_2b's (T=S=3072 and a 512-token chunk over 3072 keys, 10
  query heads over one KV head of 256, window 2048) over the key tile at
  D = 256,

each beside ``scaled_dot_product_attention`` on the same inputs (timed here,
never called by the port).  Prints the card's name and power limit, ptxas's
registers and spills of each variant's kernels, and one JSON line.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.dont_write_bytecode = True

# (type, D) -> tile choices of K1-bwd: (rows, split, dq_keys)
BWD_VARIANTS = {(torch.float32, 128): [(16, 1, 16), (32, 1, 16), (16, 1, 32), (16, 1, 64),
                                       (32, 2, 16)],
                (torch.bfloat16, 128): [(32, 1, 32), (32, 1, 64), (16, 1, 32)]}
# D -> key tiles of K1's fp32 forward
FWD_VARIANTS = {128: [32, 64], 256: [32, 16]}
CTYPE = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}


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
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def variants():
    """(name, kernel, source line to replace, its replacement, apply) of
    every variant; ``apply`` points the wrappers at the variant's tiles."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import flash_attention_bwd as bwd_mod
    out = []
    for (dtype, D), choices in BWD_VARIANTS.items():
        base = bwd_mod.TILES[(dtype, D)]
        line = f"template <> struct BwdTiles<{CTYPE[dtype]}, {D}> : TilesOf<{base[0]}, {base[1]}, {base[2]}> {{}};"
        for tiles in choices:
            new = f"template <> struct BwdTiles<{CTYPE[dtype]}, {D}> : TilesOf<{tiles[0]}, {tiles[1]}, {tiles[2]}> {{}};"

            def apply(dtype=dtype, D=D, tiles=tiles):
                bwd_mod.TILES[(dtype, D)] = tiles
                bwd_mod.plan.cache_clear()
                bwd_mod._kernel.cache_clear()
            name = f"bwd_{str(dtype)[6:]}_{D}_{tiles[0]}x{tiles[1]}x{tiles[2]}"
            out.append((name, "flash_attention_bwd", line, new, apply))
    for D, choices in FWD_VARIANTS.items():
        line = f"repro_torch::launch_f32<{D}, {flash_mod.F32_KEYS[D]}>("
        for bk in choices:
            def apply(D=D, bk=bk):
                flash_mod.F32_KEYS[D] = bk
                flash_mod._kernels.cache_clear()
            out.append((f"fwd_f32_{D}_{bk}", "flash_attention", line,
                        f"repro_torch::launch_f32<{D}, {bk}>(", apply))
    return out


def build_variants(vs):
    from repro_torch.kernels import _build
    root = ROOT / "build" / "tiles"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, kernel, line, new, _ in vs:
        d = root / name
        shutil.copytree(_build.CSRC, d)
        src = d / f"{kernel}.cu"
        text = src.read_text()
        if line not in text:
            raise RuntimeError(f"{name}: the line {line!r} is not in {kernel}.cu")
        src.write_text(text.replace(line, new))
        lib = d / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs, logs = {}, {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{out}")
        libs[name], logs[name] = lib, out
    return libs, logs


def resources(log, fragment):
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and fragment in line:
            regs = spills = None
            for nxt in lines[i + 1:i + 6]:
                if "spill stores" in nxt:
                    spills = nxt.strip()
                if "Used" in nxt and "registers" in nxt:
                    regs = int(nxt.split("Used")[1].split()[0])
            return {"registers": regs, "spills": spills}
    return None


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None, help="also write the JSON line here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_fp32_tiles: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import flash_attention_bwd as bwd_mod
    _build.build()
    vs = variants()
    libs, logs = build_variants(vs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, T, S, Hq, Hkv, D = 4, 512, 512, 16, 2, 128
    results = {"card": smi, "bwd": {}, "fwd": {}, "sdpa": {}}

    def inputs(shape, dtype):
        b, t, s, hq, hkv, d = shape
        q = torch.randn((b, t, hq, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
        return q, k, v

    bwd_in = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = inputs((B, T, S, Hq, Hkv, D), dtype)
        dout = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dtype)
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        exp = torch.autograd.grad(ops.flash_attention(*leaves, force="plain"), leaves,
                                  dout.float())
        bwd_in[dtype] = (q, k, v, dout, exp)
        qh = q.transpose(1, 2).contiguous().requires_grad_()
        kh = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous().requires_grad_()
        vh = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous().requires_grad_()
        doh = dout.transpose(1, 2).contiguous()

        def fwd():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

        def fwd_bwd():
            return torch.autograd.grad(fwd(), (qh, kh, vh), doh)
        results["sdpa"][str(dtype)] = {
            "forward_graph_ms": graph_ms(fwd),
            "backward_ms": events_ms(fwd_bwd) - events_ms(fwd)}
    rg = {}
    for T2 in (3072, 512):
        q, k, v = inputs((1, T2, 3072, 10, 1, 256), torch.float32)
        exp = ops.flash_attention(q, k, v, window=2048, force="plain")
        qi = torch.arange(T2, device="cuda")[:, None] + (3072 - T2)
        kj = torch.arange(3072, device="cuda")[None, :]
        mask = (kj <= qi) & (qi - kj < 2048)
        qh, kh, vh = (x.repeat_interleave(10 // x.shape[2], dim=2).transpose(1, 2).contiguous()
                      for x in (q, k, v))
        results["sdpa"][f"recurrentgemma_T{T2}"] = graph_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
        rg[T2] = (q, k, v, exp)
    q32, k32, v32 = bwd_in[torch.float32][:3]
    fwd_exp = ops.flash_attention(q32, k32, v32, force="plain")

    for name, kernel, _, _, apply in vs:
        saved = _build._libs[kernel]
        _build._libs[kernel] = ctypes.CDLL(str(libs[name]))
        keys, tiles = dict(flash_mod.F32_KEYS), dict(bwd_mod.TILES)
        apply()
        try:
            if kernel == "flash_attention_bwd":
                dtype = torch.float32 if "float32" in name else torch.bfloat16
                q, k, v, dout, exp = bwd_in[dtype]
                out, lse = flash_mod.flash_attention(q, k, v, return_lse=True)
                got = bwd_mod.flash_attention_bwd(q, k, v, out, dout, lse)
                largest = max(float(e.abs().max()) for e in exp)
                err = max(float((g.float() - e).abs().max()) for g, e in zip(got, exp)) / largest
                tol = 1e-3 if dtype == torch.float32 else 2e-2
                if not err <= tol:
                    raise AssertionError(f"{name}: error {err} of the largest entry")

                def kern():
                    return bwd_mod.flash_attention_bwd(q, k, v, out, dout, lse)
                tname = "f" if dtype == torch.float32 else "13__nv_bfloat16"
                results["bwd"][name] = {
                    "err": err, "ms": events_ms(kern), "graph_ms": graph_ms(kern),
                    "dkdv": resources(logs[name], f"flash_bwd_dkdv_kernelI{tname}Li128E"),
                    "dq": resources(logs[name], f"flash_bwd_dq_kernelI{tname}Li128E")}
            else:
                Dv = int(name.split("_")[2])
                bk = flash_mod.F32_KEYS[Dv]
                row = {"ptxas": resources(logs[name], f"flash_fwd_f32_kernelILi{Dv}ELi{bk}E")}
                cases = ([("training", q32, k32, v32, fwd_exp, None)] if Dv == 128 else
                         [(f"recurrentgemma_T{T2}", *rg[T2], 2048) for T2 in (3072, 512)])
                for label, q, k, v, exp, window in cases:
                    got = flash_mod.flash_attention(q, k, v, window=window)
                    err = float((got - exp).abs().max())
                    if not torch.allclose(got, exp, rtol=2e-4, atol=2e-4):
                        raise AssertionError(f"{name} {label}: max abs err {err}")
                    row[label] = {"err": err,
                                  "ms": events_ms(lambda: flash_mod.flash_attention(
                                      q, k, v, window=window)),
                                  "graph_ms": graph_ms(lambda: flash_mod.flash_attention(
                                      q, k, v, window=window))}
                results["fwd"][name] = row
        finally:
            _build._libs[kernel] = saved
            flash_mod.F32_KEYS.clear()
            flash_mod.F32_KEYS.update(keys)
            bwd_mod.TILES.clear()
            bwd_mod.TILES.update(tiles)
            bwd_mod.plan.cache_clear()
            bwd_mod._kernel.cache_clear()
            flash_mod._kernels.cache_clear()
        print(name, json.dumps(results["bwd"].get(name) or results["fwd"].get(name)), flush=True)
    line = json.dumps(results)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
