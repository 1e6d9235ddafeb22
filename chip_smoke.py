#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

From the root of a checkout: puts ``src`` on ``sys.path`` and imports only
``repro_torch``.  In order, it

1. probes the toolchain (torch, CUDA, nvcc, triton, CUTLASS headers, the
   card's name and power limit);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and prints the build seconds and ptxas's
   register and spill counts;
3. holds each kernel against its plain PyTorch version on the card, over the
   shape grids of ``tests/test_kernels.py`` and at the llama3_8b shapes (K1,
   K2) or the mamba2_370m prefill shapes (K3) (tolerance 2e-4 in fp32, 5e-4
   at the SSD property points, 2e-2 in bf16), K2 at the edges of its
   partitions, and times kernel, plain version and, where PyTorch has one,
   a library call at those shapes, each as 20 calls back to back between
   CUDA events (``ms``, the method of every earlier run); the kernel and
   the library call also as 20 calls captured in a CUDA graph and replayed,
   with the host out of the way (``graph_ms``).  It also prints each
   kernel's host cost a call, the device time of each launch (K1's one, K2's
   and K3's two; torch.profiler), K1's plan and ptxas's registers and spills
   for the kernel it picks, and K3 at the ragged serving chunk (T=379) and
   at T=2048 and 8192.  K1's grid adds the bf16 kernel's GQA packing (G=8
   at D=128, G=6), windows with G > 1, T and S - T off the tile grids, D=32
   and 64, and B=2 views of a larger slot cache;
4. builds llama3_8b at full width and depth in bf16 from a seeded generator
   on the card and compares its prefill and decode logits with the kernels
   against the same calls with the plain attention;
5. serves 8 requests (prompts of 128-1024 tokens, 32 new tokens each)
   through ``build_stack(mode="real")``, with every kernel launch count set
   to 0 just before and read just after, and checks that every request got
   its 32 tokens and that both kernels ran; it logs the (B, T, S) of every
   K1 launch and checks that K1 ran in every layer of every prefill chunk;
6. serves the same requests again under ``torch.profiler`` and prints the
   device time by kernel and the device's busy and idle shares;
7. builds mamba2_370m at full width and depth in bf16 from a seeded
   generator and compares its logits with K3 against the plain scan after a
   256-token prefill, a ragged 379-token chunk from the carried state, and a
   decode: in fp32 to 2e-3, and in bf16 by their distance from the fp32
   model's logits;
8. serves the same 8 requests through ``build_stack(mode="real")`` with
   mamba2_370m, counts set to 0 just before and read just after, and checks
   that every request got its 32 tokens and that K3 ran;
9. profiles that serving run as in 6.

It prints one JSON ``kernels`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  ``--kernels-only`` stops after
phase 3 and prints neither (a quick check of the kernels alone).  Any failure raises and the exit
code is not 0; without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import collections
import itertools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.dont_write_bytecode = True
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SERVING = dict(num=8, prompt_min=128, prompt_max=1024, new_tokens=32, seed=0)


def log(msg: str) -> None:
    print(msg, flush=True)


def sh(cmd) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (res.stdout + res.stderr).strip()


# -------------------------------------------------------------------------
# 1. probe
# -------------------------------------------------------------------------

def probe() -> str:
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    log("nvcc: " + sh([nvcc, "--version"]).splitlines()[-1])
    try:
        import triton
        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import ({e})")
    cutlass = Path("/usr/local/cutlass/include/cutlass/cutlass.h")
    log(f"CUTLASS headers under /usr/local/cutlass/include: {cutlass.exists()}")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log(f"nvidia-smi: {smi}")
    log(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
    return smi


# -------------------------------------------------------------------------
# 3. kernels against their plain versions
# -------------------------------------------------------------------------

def assert_close(name, out, exp, dtype_name, tol=None):
    tol = tol or TOL[dtype_name]
    o, e = out.float(), exp.float()
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = float((o - e).abs().max())
    bad = float(((o - e).abs() - (tol + tol * e.abs())).max())
    log(f"  {name:58s} max_abs_err {err:.3e}  {'ok' if bad <= 0 else 'FAIL'}")
    if bad > 0:
        raise AssertionError(f"{name}: outside rtol=atol={tol} (max abs err {err})")
    return err


def qkv(gen, B, T, S, Hq, Hkv, D, dtype):
    dev = "cuda"
    q = torch.randn((B, T, Hq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    return q, k, v


def paged_inputs(gen, B, Hq, Hkv, D, page, pps, dtype, num_pages=None):
    dev = "cuda"
    num_pages = num_pages or (B * pps + 1)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((num_pages, page, Hkv, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((num_pages, page, Hkv, D), generator=gen, device=dev).to(dtype)
    bt = torch.arange(B * pps, dtype=torch.int32, device=dev).view(B, pps)
    cl = torch.randint(1, page * pps + 1, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    return q, kp, vp, bt, cl


def check_flash_grid(ops):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for shape in [(1, 128, 128, 4, 4, 64), (2, 128, 256, 8, 2, 64), (1, 64, 64, 4, 1, 128),
                  (1, 100, 100, 2, 2, 64), (1, 32, 160, 4, 4, 32)]:
        for dt in ("float32", "bfloat16"):
            cases.append((shape, dt, {}))
    # window, non-causal and the property-sweep points in both types (fp32
    # and bf16 run different kernels).  The custom scale stays fp32, as in
    # tests/test_kernels.py: at scale 0.5 the bf16 plain version, which
    # rounds q.k to bf16 before scaling, is itself more than 2e-2 from exact.
    cases.append(((1, 64, 64, 2, 2, 64), "float32", {"softmax_scale": 0.5}))
    for dt in ("float32", "bfloat16"):
        for window in (16, 64, 4096):
            cases.append(((1, 128, 128, 4, 2, 64), dt, {"window": window}))
        cases.append(((2, 64, 64, 4, 4, 64), dt, {"causal": False}))
        for T, extra, Hkv, G, D in [(8, 0, 1, 1, 32), (33, 16, 2, 2, 64), (64, 93, 1, 4, 32),
                                    (127, 0, 2, 4, 64), (127, 93, 2, 1, 32),
                                    (33, 93, 1, 2, 128)]:
            cases.append(((1, T, T + extra, Hkv * G, Hkv, D), dt, {}))
    # the bf16 kernel's packing and tiles: G=8 at D=128 (qwen2_5_3b's widths,
    # Hq=16, Hkv=2), windows with G > 1, T off the query tile grid with S - T
    # off the KV tile grid, D=32 and 64, and a packing that does not fill G
    for shape, kw in [((1, 512, 1024, 16, 2, 128), {}), ((2, 77, 300, 16, 2, 128), {}),
                      ((1, 200, 260, 8, 2, 64), {"window": 48}),
                      ((1, 129, 400, 32, 8, 128), {"window": 100}),
                      ((1, 45, 173, 32, 8, 128), {}), ((1, 333, 1000, 4, 1, 32), {}),
                      ((2, 150, 301, 12, 4, 64), {}), ((1, 97, 97, 6, 1, 32), {}),
                      ((1, 70, 70, 16, 2, 128), {"causal": False})]:
        cases.append((shape, "bfloat16", kw))
    for shape, dt, kw in cases:
        q, k, v = qkv(gen, *shape, getattr(torch, dt))
        out = ops.flash_attention(q, k, v, **kw)
        exp = ops.flash_attention(q, k, v, force="plain", **kw)
        torch.cuda.synchronize()
        assert_close(f"K1 {shape} {dt} {kw}", out, exp, dt)
    # B=2 views of a larger slot cache (batch stride 2048 positions), as the
    # model passes k_c[:, :s1]
    cache = torch.randn((2, 3, 2048, 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
    for T, S in ((200, 456), (64, 64)):
        q = torch.randn((2, T, 32, 128), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = cache[0, 1:, :S], cache[1, 1:, :S]
        assert_close(f"K1 slot-cache views B=2 T={T} S={S} bfloat16", ops.flash_attention(q, k, v),
                     ops.flash_attention(q, k, v, force="plain"), "bfloat16")


def check_paged_grid(ops):
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for shape in [(2, 4, 4, 64, 16, 4), (3, 8, 2, 64, 16, 3), (1, 4, 1, 128, 32, 2),
                  (4, 2, 2, 32, 8, 5)]:
        for dt in ("float32", "bfloat16"):
            cases.append((shape, dt))
    for B, Hkv, G, page, pps in [(1, 1, 1, 8, 1), (4, 2, 4, 16, 5), (3, 1, 2, 8, 3),
                                 (2, 2, 2, 16, 2)]:
        cases.append(((B, Hkv * G, Hkv, 32, page, pps), "float32"))
    for shape, dt in cases:
        q, kp, vp, bt, cl = paged_inputs(gen, *shape, getattr(torch, dt))
        out = ops.paged_attention(q, kp, vp, bt, cl)
        exp = ops.paged_attention(q, kp, vp, bt, cl, force="plain")
        torch.cuda.synchronize()
        assert_close(f"K2 {shape} {dt}", out, exp, dt)
    # scattered tables and a one-token context
    q, kp, vp, _, _ = paged_inputs(gen, 2, 4, 2, 64, 16, 3, torch.float32, num_pages=32)
    bt = torch.tensor([[31, 2, 17], [9, 25, 0]], dtype=torch.int32, device="cuda")
    cl = torch.tensor([40, 33], dtype=torch.int32, device="cuda")
    assert_close("K2 scattered tables", ops.paged_attention(q, kp, vp, bt, cl),
                 ops.paged_attention(q, kp, vp, bt, cl, force="plain"), "float32")
    q, kp, vp, bt, _ = paged_inputs(gen, 1, 2, 2, 32, 8, 2, torch.float32)
    cl = torch.tensor([1], dtype=torch.int32, device="cuda")
    assert_close("K2 ctx=1", ops.paged_attention(q, kp, vp, bt, cl),
                 ops.paged_attention(q, kp, vp, bt, cl, force="plain"), "float32")
    check_paged_partitions(ops, gen)


def check_paged_partitions(ops, gen):
    """K2 at the edges of its partitions (``paged_attention.PARTITION`` keys):
    contexts of 1, one partition, one key past it and the full 2048 (32
    partitions) in one batch over scattered tables at the llama3_8b widths;
    against the plain version and against the plain split-and-merge, in
    both types.  An empty context gives 0, as in the Pallas kernel."""
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels import ref
    part = paged_mod.PARTITION
    B, Hq, Hkv, D, page, pps = 5, 32, 8, 128, 16, 128
    lens = [1, part, part + 1, pps * page, 2 * part - 1]
    for dt in ("float32", "bfloat16"):
        q, kp, vp, _, _ = paged_inputs(gen, B, Hq, Hkv, D, page, pps, getattr(torch, dt))
        bt = torch.randperm(kp.shape[0], generator=gen, device="cuda")[:B * pps]
        bt = bt.to(torch.int32).view(B, pps).contiguous()
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = ops.paged_attention(q, kp, vp, bt, cl)
        torch.cuda.synchronize()
        assert_close(f"K2 partition edges {lens} {dt}", out,
                     ops.paged_attention(q, kp, vp, bt, cl, force="plain"), dt)
        assert_close(f"K2 partition edges {lens} {dt} vs plain split", out,
                     ref.paged_attention_split(q, kp, vp, bt, cl), dt)
    cl = torch.tensor([0, 3], dtype=torch.int32, device="cuda")
    q, kp, vp, bt, _ = paged_inputs(gen, 2, 4, 2, 64, 16, 20, torch.float32)
    out = ops.paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    if out[0].abs().max() != 0 or not torch.isfinite(out).all():
        raise AssertionError("K2: an empty context must give 0")
    assert_close("K2 ctx=3 beside an empty context", out[1:],
                 ops.paged_attention(q, kp, vp, bt, cl, force="plain")[1:], "float32")


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, reps=5) -> float:
    """Device time a call of ``fn`` with the host out of the way: ``iters``
    calls captured in one CUDA graph, replayed ``reps`` times between CUDA
    events.  That the capture works also shows that ``fn`` reads no device
    value on the host."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def host_us(fn, n=200) -> float:
    """Host time to issue one call of ``fn`` (the device is not waited for)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def pass_ms(fn, names, iters=20):
    """Device time per call of each launch whose kernel name contains one of
    ``names``, from torch.profiler over ``iters`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in names:
            if name in evt.key:
                out[name] += getattr(evt, "self_device_time_total", 0) / 1e3 / iters
    return out


def kernel_resources(log: str, name: str):
    """Registers, spill stores and loads (bytes) that ptxas reported for the
    first kernel whose mangled name contains ``name``; None where the log
    does not have it (a library built by an earlier run)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            res = {"registers": None, "spill_stores": None, "spill_loads": None}
            for nxt in lines[i + 1:i + 6]:
                if "spill stores" in nxt:
                    nums = [int(w) for w in nxt.replace(",", " ").split() if w.isdigit()]
                    res["spill_stores"], res["spill_loads"] = nums[1], nums[2]
                if "Used" in nxt and "registers" in nxt:
                    res["registers"] = int(nxt.split("Used")[1].split()[0])
            return res
    return None


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def measure_flash(ops):
    """K1 at the llama3_8b prefill shape: one 512-token chunk after 512
    cached tokens.  Besides the times, the device time of one launch
    (torch.profiler), the bf16 kernel's plan there and ptxas's registers
    and spills for the kernel that plan picks."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash_mod
    B, T, S, Hq, Hkv, D = 1, 512, 1024, 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = qkv(gen, B, T, S, Hq, Hkv, D, torch.bfloat16)
    out = ops.flash_attention(q, k, v)
    exp = ops.flash_attention(q, k, v, force="plain")
    torch.cuda.synchronize()
    err = assert_close(f"K1 llama3_8b {(B, T, S, Hq, Hkv, D)} bfloat16", out, exp, "bfloat16")
    ms = time_ms(lambda: ops.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: ops.flash_attention(q, k, v, force="plain"))
    g_ms = graph_ms(lambda: ops.flash_attention(q, k, v))
    h_us = host_us(lambda: ops.flash_attention(q, k, v))
    # library yardstick: SDPA with the bottom-right causal mask, KV heads
    # repeated and laid out (B, H, S, D) before timing
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    qi = torch.arange(T, device="cuda")[:, None] + (S - T)
    mask = torch.arange(S, device="cuda")[None, :] <= qi
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib_err = float((lib.transpose(1, 2).float() - exp.float()).abs().max())
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    library_g_ms = graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    pairs = sum(min(S, i + (S - T) + 1) for i in range(T))
    flops = 4 * D * Hq * B * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    launch_ms = pass_ms(lambda: ops.flash_attention(q, k, v), ("flash_fwd_wgmma",))
    p = flash_mod.plan(B, T, S, Hq, Hkv, D)
    res = kernel_resources(_build.build_log.get("flash_attention", ""),
                           f"flash_fwd_wgmma_kernelILi{D}ELi{p.block_keys}ELi{p.block_rows // 64}E")
    log(f"K1 llama3_8b: kernel {ms:.4f} ms ({g_ms:.4f} in a graph; device time per launch "
        f"{launch_ms['flash_fwd_wgmma']:.4f} ms), plain {plain_ms:.4f} ms, "
        f"SDPA {library_ms:.4f} ms ({library_g_ms:.4f} in a graph) "
        f"(SDPA vs plain max abs err {lib_err:.3e}), bound {b_ms:.5f} ms by {b_by} "
        f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB); "
        f"fp32-core bound {flops / PEAK_FP32_FLOPS * 1e3:.5f} ms; host {h_us:.1f} us a call")
    log(f"K1 plan at that shape: {p}; ptxas for its kernel: {res}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:109",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "graph_ms": g_ms,
            "library_graph_ms": library_g_ms, "host_us": h_us,
            "launch_ms": launch_ms["flash_fwd_wgmma"], "tiles": [p.block_rows, p.block_keys],
            "smem_bytes": p.smem_bytes, "ptxas": res}


def measure_paged(ops):
    """K2 at the llama3_8b decode shape: 8 sequences, page 16, 128 pages
    each, contexts up to 1056."""
    B, Hq, Hkv, D, page, pps = 8, 32, 8, 128, 16, 128
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(B * pps, generator=gen, device="cuda").to(torch.int32)
    bt = perm.view(B, pps).contiguous()
    cl = torch.tensor([1056, 129, 1000, 512, 777, 1, 300, 1024], dtype=torch.int32,
                      device="cuda")
    out = ops.paged_attention(q, kp, vp, bt, cl)
    exp = ops.paged_attention(q, kp, vp, bt, cl, force="plain")
    torch.cuda.synchronize()
    err = assert_close(f"K2 llama3_8b {(B, Hq, Hkv, D, page, pps)} bfloat16", out, exp,
                       "bfloat16")
    # timed over four KV pools in turn (80 MB, more than the 50 MB L2), so
    # that each launch reads its pages from device memory, as a decode step
    # does after the layer's weights have streamed through the cache
    pools = [(kp, vp)] + [tuple(torch.randn(kp.shape, generator=gen, device="cuda")
                                .to(torch.bfloat16) for _ in range(2)) for _ in range(3)]
    turn = itertools.cycle(pools)
    ms = time_ms(lambda: ops.paged_attention(q, *next(turn), bt, cl))
    plain_ms = time_ms(lambda: ops.paged_attention(q, *next(turn), bt, cl, force="plain"))
    # library yardstick: SDPA over the gathered contexts with a length mask,
    # gathered and laid out (B, H, S, D) before timing
    Smax = int(cl.max())
    kg = kp[bt.long()].reshape(B, pps * page, Hkv, D)[:, :Smax]
    vg = vp[bt.long()].reshape(B, pps * page, Hkv, D)[:, :Smax]
    kh = kg.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    vh = vg.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    qh = q[:, :, None, :]
    mask = (torch.arange(Smax, device="cuda")[None, :] < cl[:, None])[:, None, None, :]
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib_err = float((lib[:, :, 0].float() - exp.float()).abs().max())
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    library_g_ms = graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    g_ms = graph_ms(lambda: ops.paged_attention(q, *next(turn), bt, cl))
    h_us = host_us(lambda: ops.paged_attention(q, *next(turn), bt, cl))
    passes = pass_ms(lambda: ops.paged_attention(q, *next(turn), bt, cl),
                     ("paged_fwd_partial", "paged_fwd_merge"))
    log("K2 llama3_8b device time per pass: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items()))
    ctx = int(cl.sum())
    flops = 4 * Hq * D * ctx
    nbytes = 2 * (q.numel() + out.numel()) + 2 * 2 * ctx * Hkv * D + 4 * (bt.numel() + B)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"K2 llama3_8b: kernel {ms:.4f} ms ({g_ms:.4f} in a graph), plain {plain_ms:.4f} ms, "
        f"SDPA {library_ms:.4f} ms ({library_g_ms:.4f} in a graph) "
        f"(SDPA vs plain max abs err {lib_err:.3e}), bound {b_ms:.5f} ms by {b_by} "
        f"({nbytes / 1e6:.3f} MB, contexts {cl.tolist()}); host {h_us:.1f} us a call")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:88",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "graph_ms": g_ms,
            "library_graph_ms": library_g_ms, "host_us": h_us}


def ssd_inputs(gen, B, T, H, P, N, dtype, carry=False):
    """Inputs of K3 with realistic decays, dA = -softplus(normal)."""
    dev = "cuda"
    xdt = torch.randn((B, T, H, P), generator=gen, device=dev)
    dA = -F.softplus(torch.randn((B, T, H), generator=gen, device=dev))
    Bm = torch.randn((B, T, N), generator=gen, device=dev)
    Cm = torch.randn((B, T, N), generator=gen, device=dev)
    s0 = torch.randn((B, H, N, P), generator=gen, device=dev) if carry else None
    return [t.to(dtype) for t in (xdt, dA, Bm, Cm)], s0


def check_ssd_grid(ops):
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [((1, 128, 2, 64, 32), 128, "float32", None, False),   # single chunk
             ((2, 256, 2, 64, 32), 128, "float32", None, False),   # two chunks
             ((1, 512, 1, 32, 64), 128, "float32", None, False),   # four chunks
             ((2, 64, 4, 16, 16), 32, "float32", None, False),     # small chunks
             ((1, 96, 2, 32, 32), 32, "float32", None, False),     # non-power-of-two T
             ((1, 128, 2, 32, 32), 64, "bfloat16", None, False)]   # bf16 inputs
    # the property sweep of tests/test_kernels.py, as fixed points, at 5e-4
    for n, chunk, H, P, N in [(1, 16, 1, 16, 16), (4, 64, 3, 32, 32), (2, 32, 2, 16, 32),
                              (3, 16, 3, 32, 16), (1, 64, 2, 16, 16), (4, 32, 1, 32, 16)]:
        cases.append(((1, n * chunk, H, P, N), chunk, "float32", 5e-4, False))
    # what the Pallas kernel does not take: ragged T, a carried state, bf16 with both
    for shape, chunk, dt in [((2, 37, 2, 16, 16), 16, "float32"),
                             ((1, 5, 2, 32, 32), 16, "float32"),
                             ((2, 200, 2, 64, 32), 64, "float32"),
                             ((1, 150, 2, 32, 32), 64, "bfloat16"),
                             ((3, 2000, 4, 32, 32), 32, "float32")]:   # 63 chunks
        cases.append((shape, chunk, dt, None, True))
    # the mamba2_370m prefill shapes: a full 512-token chunk and a ragged one
    for T, carry in ((512, False), (512, True), (379, True)):
        cases.append(((1, T, 32, 64, 128), 128, "float32", None, carry))
    for shape, chunk, dt, tol, carry in cases:
        (xdt, dA, Bm, Cm), s0 = ssd_inputs(gen, *shape, getattr(torch, dt), carry)
        y, st = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=chunk, initial_state=s0)
        y_exp, st_exp = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=chunk, initial_state=s0,
                                     force="plain")
        torch.cuda.synchronize()
        what = f"K3 {shape} chunk {chunk} {dt}{' carried state' if carry else ''}"
        assert_close(what + " y", y, y_exp, dt, tol)
        assert_close(what + " state", st, st_exp, dt, tol)


def ssd_flops(B, T, H, P, N, Q):
    """Operations of the chunked SSD algorithm on these inputs, counting the
    rows of a ragged last chunk only: C·Bᵀ over the causal triangle once per
    (sequence, chunk), since it does not depend on the head; per (sequence,
    head, chunk) the L weighting, (C·Bᵀ ∘ L)·xdt over the triangle,
    exp(cum)·C·S and the state update.  The exponentials are not counted."""
    total = 0
    for c0 in range(0, T, Q):
        q = min(Q, T - c0)
        tri = q * (q + 1) // 2
        total += B * 2 * N * tri
        total += B * H * (tri + 2 * P * tri + (2 * q * N * P + q * P)
                          + (2 * q * N * P + q * P + N * P))
    return total


def measure_ssd(ops):
    """K3 at the mamba2_370m prefill shape: one 512-token chunk of one
    sequence from a carried state, fp32, as the SSD layer calls it; then the
    ragged 379-token chunk of the serving traffic, and prefill budgets of
    2048 and 8192 tokens (16 and 64 chunks), where the state passing along
    the chunks would show if it grew faster than the chunks."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    B, T, H, P, N, Q = 1, 512, 32, 64, 128, 128
    gen = torch.Generator(device="cuda").manual_seed(6)
    (xdt, dA, Bm, Cm), s0 = ssd_inputs(gen, B, T, H, P, N, torch.float32, carry=True)
    y, st = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0)
    y_exp, st_exp = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0, force="plain")
    y_two, st_two = ref.ssd_scan_two_pass(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0)
    torch.cuda.synchronize()
    err = max(assert_close(f"K3 mamba2_370m {(B, T, H, P, N)} y", y, y_exp, "float32"),
              assert_close(f"K3 mamba2_370m {(B, T, H, P, N)} state", st, st_exp, "float32"))
    assert_close("K3 plain two passes vs plain y", y_two, y_exp, "float32")
    assert_close("K3 plain two passes vs plain state", st_two, st_exp, "float32")
    ms = time_ms(lambda: ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0))
    plain_ms = time_ms(lambda: ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0,
                                            force="plain"))
    g_ms = graph_ms(lambda: ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0))
    h_us = host_us(lambda: ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0))
    passes = pass_ms(lambda: ops.ssd_scan(xdt, dA, Bm, Cm, chunk=Q, initial_state=s0),
                     ("ssd_fwd_chunk", "ssd_fwd_scan"))
    log(f"K3 mamba2_370m T={T} device time per pass (column tile "
        f"{ssd_mod.col_tile(P)}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items()))
    flops = ssd_flops(B, T, H, P, N, Q)
    nbytes = 4 * (xdt.numel() + dA.numel() + Bm.numel() + Cm.numel() + s0.numel()
                  + y.numel() + st.numel())
    b_ms, b_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
    log(f"K3 mamba2_370m: kernel {ms:.4f} ms ({g_ms:.4f} in a graph), plain {plain_ms:.4f} ms, "
        f"no library call, "
        f"bound {b_ms:.5f} ms by {b_by} ({flops / 1e9:.4f} GFLOP at the fp32 rate, "
        f"{nbytes / 1e6:.3f} MB); host {h_us:.1f} us a call")
    # the ragged serving chunk (379 tokens) and long prefill budgets, each
    # from a carried state
    for T2 in (379, 2048, 8192):
        (x2, a2, B2, C2), s2 = ssd_inputs(gen, B, T2, H, P, N, torch.float32, carry=True)
        y2, st2 = ops.ssd_scan(x2, a2, B2, C2, chunk=Q, initial_state=s2)
        y2_exp, st2_exp = ops.ssd_scan(x2, a2, B2, C2, chunk=Q, initial_state=s2, force="plain")
        torch.cuda.synchronize()
        assert_close(f"K3 mamba2_370m T={T2} y", y2, y2_exp, "float32")
        assert_close(f"K3 mamba2_370m T={T2} state", st2, st2_exp, "float32")
        ms2 = time_ms(lambda: ops.ssd_scan(x2, a2, B2, C2, chunk=Q, initial_state=s2))
        g2 = graph_ms(lambda: ops.ssd_scan(x2, a2, B2, C2, chunk=Q, initial_state=s2))
        plain2 = time_ms(lambda: ops.ssd_scan(x2, a2, B2, C2, chunk=Q, initial_state=s2,
                                              force="plain"))
        passes2 = pass_ms(lambda: ops.ssd_scan(x2, a2, B2, C2, chunk=Q, initial_state=s2),
                          ("ssd_fwd_chunk", "ssd_fwd_scan"))
        nbytes2 = 4 * (2 * x2.numel() + a2.numel() + B2.numel() + C2.numel() + 2 * s2.numel())
        b2_ms, b2_by = bound(ssd_flops(B, T2, H, P, N, Q), nbytes2, PEAK_FP32_FLOPS)
        log(f"K3 mamba2_370m T={T2}: kernel {ms2:.4f} ms ({g2:.4f} in a graph), "
            f"plain {plain2:.4f} ms, bound {b2_ms:.5f} ms by {b2_by}; device time per pass: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in passes2.items()))
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:84",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "graph_ms": g_ms,
            "library_graph_ms": None, "host_us": h_us}


# -------------------------------------------------------------------------
# 4. and 7. model checks
# -------------------------------------------------------------------------

def check_model(model, params, vocab):
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, vocab, (1, 257), generator=gen, device="cuda")
    results = {}
    for force in (None, "plain"):
        cache = model.init_cache(1, 512, torch.bfloat16, "cuda")
        pre, cache = model.prefill(params, {"tokens": toks[:, :256]}, cache, force=force)
        dec, _ = model.decode_step(params, cache, toks[:, 256:], force=force)
        results[force] = (pre.float(), dec.float())
    torch.cuda.synchronize()
    for i, what in enumerate(("prefill (256 tokens, K1)", "decode (K2)")):
        a, b = results[None][i], results["plain"][i]
        if tuple(a.shape) != (1, vocab) or not torch.isfinite(a).all():
            raise AssertionError(f"model {what}: logits {tuple(a.shape)} not finite "
                                 f"or of the wrong shape")
        rel = float((a - b).abs().max() / b.abs().max())
        log(f"model {what}: max relative error kernels vs plain {rel:.3e} "
            f"(argmax {int(a.argmax())} vs {int(b.argmax())})")
        if rel > 5e-2:
            raise AssertionError(f"model {what}: kernels and plain differ by {rel}")


def check_mamba(model, params, cfg):
    """K3 inside the full model: logits after a 256-token prefill (two full
    chunks), a ragged 379-token chunk from the carried state, and a decode.

    In fp32 (the bf16 weights widened, so nothing else in the model rounds)
    the logits with K3 must equal those with the plain scan to 2e-3, the
    repo's logit tolerance (``tests/test_models_smoke.py``).  In bf16, the
    served type, each layer rounds the scan's output to bf16, so fp32
    differences of ~1e-6 between two orders of summation flip roundings that
    48 layers carry on, and K3 and the plain scan differ by several percent
    (measured on the H100).  So the bf16 logits are held against the fp32
    model's: K3's distance from them must be at most twice the larger
    distance of two plain versions, the plain scan in chunks of 128 (the
    config's) and of 64."""
    import dataclasses

    from repro_torch.models.transformer import build_model
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (1, 636), generator=gen, device="cuda")
    what = ("prefill (256 tokens, K3)",
            "ragged prefill (379 tokens from the carried state, K3)",
            "decode (plain SSD step)")
    reblocked = build_model(cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk_size=64)))

    def run(m, p, dtype, force):
        cache = m.init_cache(1, 2048, dtype, "cuda")
        a, cache = m.prefill(p, {"tokens": toks[:, :256]}, cache, force=force)
        b, cache = m.prefill(p, {"tokens": toks[:, 256:635]}, cache, force=force)
        c, _ = m.decode_step(p, cache, toks[:, 635:], force=force)
        return [t.float() for t in (a, b, c)]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    params32 = _widen(params)
    k32, p32 = run(model, params32, torch.float32, None), run(model, params32, torch.float32,
                                                              "plain")
    del params32
    k16, p16 = run(model, params, torch.bfloat16, None), run(model, params, torch.bfloat16,
                                                             "plain")
    r16 = run(reblocked, params, torch.bfloat16, "plain")
    torch.cuda.synchronize()
    for i, w in enumerate(what):
        for a in (k32[i], k16[i]):
            if tuple(a.shape) != (1, cfg.vocab_size) or not torch.isfinite(a).all():
                raise AssertionError(f"mamba2 {w}: logits {tuple(a.shape)} not finite "
                                     f"or of the wrong shape")
        e32, e16 = rel(k32[i], p32[i]), rel(k16[i], p16[i])
        ek, ep, er = rel(k16[i], p32[i]), rel(p16[i], p32[i]), rel(r16[i], p32[i])
        log(f"mamba2 {w}: max relative error K3 vs plain {e32:.3e} in fp32 "
            f"(argmax {int(k32[i].argmax())} vs {int(p32[i].argmax())}), {e16:.3e} in bf16 "
            f"(argmax {int(k16[i].argmax())} vs {int(p16[i].argmax())}); bf16 against "
            f"the fp32 model: K3 {ek:.3e}, plain {ep:.3e}, plain in chunks of 64 {er:.3e}")
        if e32 > 2e-3:
            raise AssertionError(f"mamba2 {w}: K3 and plain differ by {e32} in fp32")
        if ek > 2 * max(ep, er):
            raise AssertionError(f"mamba2 {w}: in bf16 K3 is {ek} from the fp32 model, "
                                 f"the plain scan {max(ep, er)}")


# -------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops

    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 1. probe")
    smi = probe()

    log("== 2. build")
    secs = _build.build()
    log(f"built {list(_build.KERNELS)} in {secs:.2f} s into {_build.build_dir()}")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("== 3. kernels against their plain versions")
    check_flash_grid(ops)
    check_paged_grid(ops)
    check_ssd_grid(ops)
    kernels = [measure_flash(ops), measure_paged(ops), measure_ssd(ops)]
    if "--kernels-only" in sys.argv[1:]:
        log(f"--kernels-only: stopping after phase 3, {time.monotonic() - t_start:.1f} s")
        return 0
    launches = {}

    log("== 4. llama3_8b, full width and depth, bf16, random weights (seed 0)")
    cfg, model, params = build_full("llama3_8b")
    check_model(model, params, cfg.vocab_size)
    log("== 5. serving llama3_8b through build_stack(mode='real')")
    launches.update(serve_path(ops, cfg, model, params, ("flash_attention", "paged_attention")))
    log("== 6. where the device time goes: the same serving run under torch.profiler")
    serve_path(ops, cfg, model, params, (), profile=True)
    del model, params
    torch.cuda.empty_cache()

    log("== 7. mamba2_370m, full width and depth, bf16, random weights (seed 0)")
    cfg, model, params = build_full("mamba2_370m")
    check_mamba(model, params, cfg)
    log("== 8. serving mamba2_370m through build_stack(mode='real')")
    launches.update(serve_path(ops, cfg, model, params, ("ssd_scan",)))
    log("== 9. where the device time goes: the same serving run under torch.profiler")
    serve_path(ops, cfg, model, params, (), profile=True)

    for k in kernels:
        k["launches"] = launches[k["name"]]
        library = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        log(f"kernel {k['name']}: {k['ms']:.4f} ms a call ({k['graph_ms']:.4f} in a CUDA "
            f"graph), {k['launches']} launches on its "
            f"serving path, bound {k['bound_ms']:.5f} ms by {k['bound_by']}, plain "
            f"{k['plain_ms']:.4f} ms, library {library}, max abs err {k['max_abs_err']:.3e}")
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def build_full(arch):
    """``arch`` at full width and depth in bf16 on the card, random weights
    from seed 0; its parameter count must equal the config's."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_model
    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"initialised {n_params:,} parameters (config says {cfg.param_count():,}) "
        f"in {time.monotonic() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated")
    if n_params != cfg.param_count():
        raise AssertionError("parameter count disagrees with the config")
    return cfg, model, params


def serve_path(ops, cfg, model, params, path_kernels, profile=False):
    """Serve the smoke traffic (8 requests at once, prompts uniform in
    128-1024 from numpy seed 0, 32 new tokens each; vllm policy, 512-token
    step budget, 8 slots, no prefix caching) through ``build_stack(mode=
    "real")``.  The launch counts are set to 0 just before the run and read
    just after; every kernel in ``path_kernels`` must have launched.  Returns
    those kernels' counts.  With ``profile``, runs under torch.profiler."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.launch.serve import make_requests, run_requests
    from repro_torch.serving.scheduler import EngineConfig
    from repro_torch.serving.stack import build_stack
    engine_cfg = EngineConfig(policy="vllm", max_num_seqs=8, max_batched_tokens=512,
                              block_size=16, num_blocks=1024, enable_prefix_caching=False,
                              chip="h100-sxm")
    stack = build_stack(cfg, engine_cfg, "real", model=model, params=params,
                        max_len=2048, device="cuda", dtype=torch.bfloat16)
    reqs = make_requests(SERVING["num"], SERVING["prompt_min"], SERVING["prompt_max"],
                         SERVING["new_tokens"], cfg.vocab_size, seed=SERVING["seed"])
    if profile:
        profile_serving(lambda: run_requests(stack, reqs, timeout=600))
        return {}
    log(f"prompt lengths {[r.prompt_len for r in reqs]}")
    shapes = collections.Counter()
    flash = flash_mod.flash_attention

    def record(q, k, v, **kw):      # the (B, T, S) of every K1 launch
        shapes[(q.shape[0], q.shape[1], k.shape[1])] += 1
        return flash(q, k, v, **kw)

    flash_mod.flash_attention = record
    ops.reset_launch_counts()
    try:
        summary = run_requests(stack, reqs, timeout=600)
    finally:
        flash_mod.flash_attention = flash
    counts = ops.launch_counts()
    if shapes:
        log(f"K1 launches by (B, T, S): {sorted(shapes.items())}")
        if (sum(shapes.values()) != counts["flash_attention"]
                or any(n % cfg.num_layers for n in shapes.values())):
            raise AssertionError(f"K1 did not run in every layer of every prefill chunk: "
                                 f"{dict(shapes)} over {cfg.num_layers} layers")
    steps = summary["steps"]
    log("serving: " + json.dumps(summary))
    log(f"launches during serving: {counts} over {steps} steps ("
        + ", ".join(f"{name} {counts[name] / steps:.2f}" for name in path_kernels)
        + " per step)")
    for r in reqs:
        if (r.num_generated != SERVING["new_tokens"]
                or not all(0 <= t < cfg.vocab_size for t in r.output_tokens)):
            raise AssertionError(f"request {r.request_id} produced {r.num_generated} tokens")
    if summary["finished"] != len(reqs):
        raise AssertionError(f"{summary['finished']} of {len(reqs)} requests finished")
    for name in path_kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the serving path")
    return {name: counts[name] for name in path_kernels}


def profile_serving(serve) -> None:
    """Device time by kernel over one ``serve()`` call, and the device's busy
    share of the wall time (one stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.monotonic()
        serve()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(evt, "self_device_time_total", 0) / 1e3
        if ms > 0:
            kernels.append((ms, evt.count, evt.key))
    total = sum(ms for ms, _, _ in kernels)
    if not kernels:
        log("profiler saw no device time")
        return
    groups = {"flash_attention (K1)": 0.0, "paged_attention (K2)": 0.0,
              "ssd_scan (K3)": 0.0, "matrix products": 0.0, "other": 0.0}
    for ms, _, name in kernels:
        low = name.lower()
        if "flash_fwd" in name:
            groups["flash_attention (K1)"] += ms
        elif "paged_fwd" in name:
            groups["paged_attention (K2)"] += ms
        elif "ssd_fwd" in name:
            groups["ssd_scan (K3)"] += ms
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")):
            groups["matrix products"] += ms
        else:
            groups["other"] += ms
    log(f"wall {wall_ms:.1f} ms under the profiler, device busy {total:.1f} ms "
        f"({100 * total / wall_ms:.1f}%), idle {100 * (1 - total / wall_ms):.1f}%")
    for g, ms in groups.items():
        log(f"  {g:24s} {ms:9.2f} ms  {100 * ms / total:5.1f}% of device time")
    for ms, n, name in sorted(kernels, reverse=True)[:10]:
        log(f"  {ms:9.2f} ms  x{n:<6d} {name[:110]}")


def _widen(tree):
    """The same tree with every tensor in fp32."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    return tree.float()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
