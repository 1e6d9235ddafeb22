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
   and 64, and B=2 views of a larger slot cache.  K2's grid adds its
   sliding window (windows of 1, page - 1, page, two partitions and one past
   every context), and K2 is timed again at mixtral_8x7b's decode shape
   with its 4096-key window (contexts 4000-8192), SDPA beside it with the
   window as a boolean mask.  At RecurrentGemma's and Whisper's shapes it
   holds K1 at D=256 with 10 query heads over one KV head (bf16
   and fp32, windows, ragged edges), K1 without the causal mask with S off
   the KV tile grid, and K2 at D=256 (G * D = 2560 and 4096, windows); and
   times K1 at recurrentgemma_2b's prefill (T=S=3072 and a 512-token chunk
   over 3072 keys, window 2048, bf16 and fp32) and whisper_base's
   non-causal shapes (T=S=1500 and T=64 over 1500 frames, 8 heads of 64),
   each with SDPA beside it and ptxas's registers and spills at D=256, and
   K2 at recurrentgemma_2b's decode (contexts 2049-3072, window 2048);
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
6b. holds real execution of llama3_8b against time-warp emulation of the
   same engine (``repro_torch.launch.real_vs_emulated``): a calibration
   stream and a separate evaluation stream in real mode (32 synthesized
   requests each, Poisson arrivals at 2 per second, seeds 1 and 2), a
   ``LinearPredictor`` fitted on the calibration steps, and the evaluation
   stream emulated with it and with the analytical H100 model.  It checks
   that every request finished, that K1 and K2 ran in the real runs, and
   that the emulated runs launched no kernel, left the allocated device
   memory as it was and took less wall time than the real run; it prints
   the errors and the speed-up and asserts nothing about their size;
6c. serves 8 requests that share a 1024-token prefix (the first alone, the
   other 7 after it), with prefix caching on (the runner keeps the cached
   blocks' KV) and off, and checks that the cached run hit and that every
   request's tokens equal the uncached run's, or, at the first token where
   they part, that step's logits lie within the relative 5e-2 of the model
   checks;
6d. serves the smoke traffic in a block pool too small for its decodes,
   checks that the engine preempted, and holds the tokens against the same
   traffic in phase 5's pool as in 6c;
7. builds mamba2_370m at full width and depth in bf16 from a seeded
   generator and compares its logits with K3 against the plain scan after a
   256-token prefill, a ragged 379-token chunk from the carried state, and a
   decode: in fp32 to 2e-3, and in bf16 by their distance from the fp32
   model's logits;
8. serves the same 8 requests through ``build_stack(mode="real")`` with
   mamba2_370m, counts set to 0 just before and read just after, and checks
   that every request got its 32 tokens and that K3 ran;
9. profiles that serving run as in 6;
9b. preemption with mamba2_370m, as in 6d, in fp32 (a resumed request's
   SSD state replayed through K3);
10. builds qwen3_30b_a3b at full width and depth in bf16 (30,532,110,336
   parameters, 48 MoE layers of 128 experts, top-8), compares its logits
   with K1 and K2 against the plain attention as in 4, and holds the MoE of
   layer 0 on a 512-token chunk with its grouped products
   (``torch._grouped_mm``) against the per-expert loop (2e-2), timing both;
11. serves the 8 requests of 5 with it, counts as in 5, and checks that K1
   ran in every layer of every chunk and that K2 ran;
12. profiles that run as in 6, with the MoE layers' device time (routing,
   dispatch, grouped products, combine) as a group of its own;
13. builds mixtral_8x7b at full width with 16 of its 32 layers
   (23,482,470,400 parameters) and compares the logits of a 6144-token
   prefill (three 2048-token chunks) and of a decode at position 6144, K1
   and K2 with the 4096-token window against the plain attention, beside
   the same weights without the window;
14. serves one request of 6144 prompt tokens and 64 new ones in a cache of
   8192 through ``build_stack(mode="real")`` and checks that K1 ran the
   window over more keys than it holds and K2 ran every decode with it,
   logging K1's (B, T, S, window, causal) and K2's windows;
15. builds recurrentgemma_2b at full size (2,894,435,840 parameters: 18
   RG-LRU and 8 local-attention layers, head_dim 256, 10 query heads over
   one KV head, window 2048) and compares the logits of a 3072-token
   prefill (three 1024-token chunks) and of a decode at position 3072 as
   in 13; times the RG-LRU recurrence at 512 and 2048 tokens and a decode;
16. serves 4 requests of 3072 prompt tokens and 32 new ones (slots of
   4096) and checks that K1 ran in every local-attention layer of every
   chunk and that K2 ran;
17. profiles that run as in 6, with the RG-LRU recurrence as a range;
18. builds whisper_base at full size (87,405,056 parameters) and compares
   the logits of a prefill with 1500 random frame embeddings and 64 tokens
   (the encoder and the cross-attention through K1 without the causal
   mask) and of a decode (cross-attention through K2 over the padded
   cross cache) with the kernels and with the plain attention; times the
   encoder;
19. serves 8 text requests (prompts of 16-256 tokens, no frames, as the
   reference's runner) and checks that K1 ran with and without the causal
   mask and that K2 ran.

Each model is freed before the next is built.  It prints one JSON
``kernels`` line (K1, K2 and K3, their launches summed over the serving
runs of 5, 6c, 6d, 8, 9b, 11, 14, 16 and 19), the card's name and power
limit, and
last ``{"ok": true, "device": {...}}``.  ``--kernels-only`` stops after
phase 3 and prints neither (a quick check of the kernels alone).  Any failure raises and the exit
code is not 0; without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import shutil
import subprocess
import sys
import time
import types
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
    # head_dim 256 with 10 query heads over one KV head (recurrentgemma_2b:
    # packed by 2 into 5 groups), windows and ragged edges; non-causal with S
    # off the KV tile grid (whisper_base's encoder and cross-attention)
    for dt in ("float32", "bfloat16"):
        for shape, kw in [((1, 100, 300, 10, 1, 256), {}), ((2, 77, 77, 10, 1, 256), {}),
                          ((1, 130, 333, 10, 1, 256), {"window": 64}),
                          ((1, 33, 1500, 10, 1, 256), {"causal": False}),
                          ((1, 150, 150, 8, 8, 64), {"causal": False}),
                          ((2, 7, 150, 8, 8, 64), {"causal": False})]:
            cases.append((shape, dt, kw))
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
    # head_dim 256, G = 10 (recurrentgemma_2b; G * D = 2560), and G * D = 4096
    for shape in [(3, 10, 1, 256, 16, 9), (2, 16, 1, 256, 8, 10), (2, 32, 1, 128, 16, 6)]:
        for dt in ("float32", "bfloat16"):
            cases.append((shape, dt))
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
    check_paged_windows(ops, gen)


def check_paged_windows(ops, gen):
    """K2's sliding window (the Pallas kernel has none): windows of 1, page
    − 1, page, two partitions and one longer than every context, over
    contexts on both sides of partition edges, against the plain version
    and the plain split-and-merge, in both types."""
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels import ref
    part = paged_mod.PARTITION
    B, Hq, Hkv, D, page, pps = 6, 8, 2, 64, 16, 24
    lens = [1, part - 1, part, part + 1, 2 * part + 5, pps * page]
    for dt in ("float32", "bfloat16"):
        q, kp, vp, _, _ = paged_inputs(gen, B, Hq, Hkv, D, page, pps, getattr(torch, dt))
        bt = torch.randperm(kp.shape[0], generator=gen, device="cuda")[:B * pps]
        bt = bt.to(torch.int32).view(B, pps).contiguous()
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for window in (1, page - 1, page, 2 * part, pps * page + 7):
            out = ops.paged_attention(q, kp, vp, bt, cl, window=window)
            torch.cuda.synchronize()
            assert_close(f"K2 window {window} contexts {lens} {dt}", out,
                         ops.paged_attention(q, kp, vp, bt, cl, window=window, force="plain"), dt)
            assert_close(f"K2 window {window} {dt} vs plain split", out,
                         ref.paged_attention_split(q, kp, vp, bt, cl, window=window), dt)
    # the same windows at head_dim 256, G = 10
    B, Hq, Hkv, D = 6, 10, 1, 256
    for dt in ("float32", "bfloat16"):
        q, kp, vp, _, _ = paged_inputs(gen, B, Hq, Hkv, D, page, pps, getattr(torch, dt))
        bt = torch.randperm(kp.shape[0], generator=gen, device="cuda")[:B * pps]
        bt = bt.to(torch.int32).view(B, pps).contiguous()
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for window in (1, part + 3, pps * page + 7):
            out = ops.paged_attention(q, kp, vp, bt, cl, window=window)
            torch.cuda.synchronize()
            assert_close(f"K2 D=256 G=10 window {window} contexts {lens} {dt}", out,
                         ops.paged_attention(q, kp, vp, bt, cl, window=window, force="plain"), dt)


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


def measure_paged_window(ops):
    """K2 at mixtral_8x7b's decode shape with its 4096-key window: 8
    sequences, page 16, 512 pages each (a cache of 8192), contexts in
    4000-8192, bf16; the same timings as :func:`measure_paged`, SDPA beside
    it with the window as a boolean mask.  The bound counts the keys the
    window lets each sequence see."""
    B, Hq, Hkv, D, page, pps, window = 8, 32, 8, 128, 16, 512, 4096
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    bt = torch.randperm(B * pps, generator=gen, device="cuda").to(torch.int32).view(B, pps)
    bt = bt.contiguous()
    cl = torch.tensor([4000, 4096, 4097, 5000, 6144, 6208, 7777, 8192], dtype=torch.int32,
                      device="cuda")
    out = ops.paged_attention(q, kp, vp, bt, cl, window=window)
    exp = ops.paged_attention(q, kp, vp, bt, cl, window=window, force="plain")
    torch.cuda.synchronize()
    err = assert_close(f"K2 mixtral_8x7b {(B, Hq, Hkv, D, page, pps)} window {window} bfloat16",
                       out, exp, "bfloat16")
    ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window))
    plain_ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window,
                                                   force="plain"))
    g_ms = graph_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window))
    h_us = host_us(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window))
    S = pps * page
    kh = kp[bt.long()].reshape(B, S, Hkv, D).repeat_interleave(Hq // Hkv, dim=2)
    vh = vp[bt.long()].reshape(B, S, Hkv, D).repeat_interleave(Hq // Hkv, dim=2)
    kh, vh = kh.transpose(1, 2).contiguous(), vh.transpose(1, 2).contiguous()
    qh = q[:, :, None, :]
    pos = torch.arange(S, device="cuda")[None, :]
    mask = ((pos < cl[:, None]) & (pos >= cl[:, None] - window))[:, None, None, :]
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib_err = float((lib[:, :, 0].float() - exp.float()).abs().max())
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    library_g_ms = graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    keys = int(torch.clamp(cl, max=window).sum())
    flops = 4 * Hq * D * keys
    nbytes = 2 * (q.numel() + out.numel()) + 2 * 2 * keys * Hkv * D + 4 * (bt.numel() + B)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"K2 mixtral_8x7b window {window}: kernel {ms:.4f} ms ({g_ms:.4f} in a graph), plain "
        f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms ({library_g_ms:.4f} in a graph) "
        f"(SDPA vs plain max abs err {lib_err:.3e}), bound {b_ms:.5f} ms by {b_by} "
        f"({nbytes / 1e6:.3f} MB, {keys} keys in the windows of contexts {cl.tolist()}); "
        f"host {h_us:.1f} us a call")
    return {"shape": [B, Hq, Hkv, D, page, pps], "window": window, "contexts": cl.tolist(),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "graph_ms": g_ms,
            "library_graph_ms": library_g_ms, "host_us": h_us}


def flash_pairs(T, S, causal, window):
    """Query-key pairs that K1 computes for one (batch, query head): every
    one without the causal mask, else the keys each query position sees."""
    if not causal:
        return T * S
    total = 0
    for i in range(T):
        p = i + S - T
        total += p + 1 - (max(0, p - window + 1) if window else 0)
    return total


def measure_flash_point(ops, gen, B, T, S, Hq, Hkv, D, dtype, causal=True, window=None):
    """K1 at one shape against its plain version, then timed as
    :func:`measure_flash` times it (``ms``, ``graph_ms``, plain), SDPA
    beside it with the same mask as a boolean tensor (KV heads repeated and
    laid out (B, H, S, D) before timing), and the bound from the pairs that
    the causal mask and the window leave."""
    dt = getattr(torch, dtype)
    q, k, v = qkv(gen, B, T, S, Hq, Hkv, D, dt)
    kw = {"causal": causal, "window": window}
    what = f"K1 {(B, T, S, Hq, Hkv, D)} {dtype} causal={causal} window={window}"
    out = ops.flash_attention(q, k, v, **kw)
    exp = ops.flash_attention(q, k, v, force="plain", **kw)
    torch.cuda.synchronize()
    err = assert_close(what, out, exp, dtype)
    del exp
    ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
    g_ms = graph_ms(lambda: ops.flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: ops.flash_attention(q, k, v, force="plain", **kw), iters=5)
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    mask = None
    if causal:
        qi = torch.arange(T, device="cuda")[:, None] + (S - T)
        kj = torch.arange(S, device="cuda")[None, :]
        mask = kj <= qi
        if window:
            mask &= qi - kj < window
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    library_g_ms = graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    flops = 4 * D * Hq * B * flash_pairs(T, S, causal, window)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS
    b_ms, b_by = bound(flops, nbytes, peak)
    log(f"{what}: kernel {ms:.4f} ms ({g_ms:.4f} in a graph), plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms ({library_g_ms:.4f} in a graph), bound {b_ms:.5f} ms by {b_by} "
        f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    return {"shape": [B, T, S, Hq, Hkv, D], "dtype": dtype, "causal": causal, "window": window,
            "max_abs_err": err, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "library_graph_ms": library_g_ms}


def measure_flash_new_shapes(ops):
    """K1 at the shapes of recurrentgemma_2b's local attention (D=256, 10
    query heads over one KV head, window 2048: a 3072-token prompt at once
    and its last 512-token chunk) in bf16 and fp32, and at whisper_base's
    non-causal shapes (8 heads of 64: the encoder over 1500 frames, a
    64-token decoder chunk over them) in bf16.  Also the bf16 kernel's plan
    and ptxas's registers and spills at D=256."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash_mod
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for dtype in ("bfloat16", "float32"):
        for T, S in ((3072, 3072), (512, 3072)):
            rows.append(measure_flash_point(ops, gen, 1, T, S, 10, 1, 256, dtype, window=2048))
    for T in (1500, 64):
        rows.append(measure_flash_point(ops, gen, 1, T, 1500, 8, 8, 64, "bfloat16", causal=False))
    log_text = _build.build_log.get("flash_attention", "")
    for T, S in ((3072, 3072), (512, 3072)):
        p = flash_mod.plan(1, T, S, 10, 1, 256)
        res = kernel_resources(log_text, f"flash_fwd_wgmma_kernelILi256ELi{p.block_keys}"
                                         f"ELi{p.block_rows // 64}E")
        log(f"K1 plan at (T={T}, S={S}, G=10, D=256): {p}; ptxas for its kernel: {res}")
    for tiles in ((64, 64), (128, 64)):
        res = kernel_resources(log_text, f"flash_fwd_wgmma_kernelILi256ELi{tiles[1]}"
                                         f"ELi{tiles[0] // 64}E")
        log(f"K1 bf16 D=256 tiles {tiles}: ptxas {res}")
    log(f"K1 fp32 D=256: ptxas {kernel_resources(log_text, 'flash_fwd_kernelIfLi256E')}")
    return rows


def measure_paged_d256(ops):
    """K2 at recurrentgemma_2b's decode shape: 4 sequences, 10 query heads
    over one KV head of 256, window 2048, page 16, 256 pages a row (a slot
    of 4096), contexts 2049-3072; timed as :func:`measure_paged_window`."""
    from repro_torch.kernels import _build
    B, Hq, Hkv, D, page, pps, window = 4, 10, 1, 256, 16, 256, 2048
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    bt = torch.arange(B * pps, dtype=torch.int32, device="cuda").view(B, pps)
    cl = torch.tensor([3072, 2049, 2500, 3072], dtype=torch.int32, device="cuda")
    out = ops.paged_attention(q, kp, vp, bt, cl, window=window)
    exp = ops.paged_attention(q, kp, vp, bt, cl, window=window, force="plain")
    torch.cuda.synchronize()
    err = assert_close(f"K2 recurrentgemma_2b {(B, Hq, Hkv, D, page, pps)} window {window} "
                       "bfloat16", out, exp, "bfloat16")
    ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window))
    plain_ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window,
                                                   force="plain"))
    g_ms = graph_ms(lambda: ops.paged_attention(q, kp, vp, bt, cl, window=window))
    S = pps * page
    kh = kp[bt.long()].reshape(B, S, Hkv, D).repeat_interleave(Hq // Hkv, dim=2)
    vh = vp[bt.long()].reshape(B, S, Hkv, D).repeat_interleave(Hq // Hkv, dim=2)
    kh, vh = kh.transpose(1, 2).contiguous(), vh.transpose(1, 2).contiguous()
    qh = q[:, :, None, :]
    pos = torch.arange(S, device="cuda")[None, :]
    mask = ((pos < cl[:, None]) & (pos >= cl[:, None] - window))[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    library_g_ms = graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    keys = int(torch.clamp(cl, max=window).sum())
    flops = 4 * Hq * D * keys
    nbytes = 2 * (q.numel() + out.numel()) + 2 * 2 * keys * Hkv * D + 4 * (bt.numel() + B)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    res = kernel_resources(_build.build_log.get("paged_attention", ""),
                           "paged_fwd_partialI13__nv_bfloat16Li256E")
    log(f"K2 recurrentgemma_2b window {window}: kernel {ms:.4f} ms ({g_ms:.4f} in a graph), "
        f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms ({library_g_ms:.4f} in a graph), "
        f"bound {b_ms:.5f} ms by {b_by} ({nbytes / 1e6:.3f} MB, {keys} keys); ptxas {res}")
    return {"shape": [B, Hq, Hkv, D, page, pps], "window": window, "contexts": cl.tolist(),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "graph_ms": g_ms,
            "library_graph_ms": library_g_ms, "ptxas": res}


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
    from repro_torch.launch.serve import engine_config, make_requests

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
    kernels[1]["windowed"] = measure_paged_window(ops)
    kernels[0]["shapes"] = measure_flash_new_shapes(ops)
    kernels[1]["d256"] = measure_paged_d256(ops)
    if "--kernels-only" in sys.argv[1:]:
        log(f"--kernels-only: stopping after phase 3, {time.monotonic() - t_start:.1f} s")
        return 0
    launches = collections.Counter()      # summed over every serving path

    log("== 4. llama3_8b, full width and depth, bf16, random weights (seed 0)")
    cfg, model, params = build_full("llama3_8b")
    check_model(model, params, cfg.vocab_size)
    log("== 5. serving llama3_8b through build_stack(mode='real')")
    launches.update(serve_path(ops, cfg, model, params, ("flash_attention", "paged_attention")))
    log("== 6. where the device time goes: the same serving run under torch.profiler")
    serve_path(ops, cfg, model, params, (), profile=True)
    log("== 6b. llama3_8b real against time-warp emulation of the same engine")
    real_against_emulated(cfg, model, params)
    log("== 6c. llama3_8b prefix-cache hits: 8 requests sharing a 1024-token prefix")
    launches.update(serve_prefix_hits(cfg, model, params))
    log("== 6d. llama3_8b preemption: the smoke traffic in a block pool too small for it")
    launches.update(serve_preempted(cfg, model, params, ("flash_attention", "paged_attention")))
    del model, params
    torch.cuda.empty_cache()

    log("== 7. mamba2_370m, full width and depth, bf16, random weights (seed 0)")
    cfg, model, params = build_full("mamba2_370m")
    check_mamba(model, params, cfg)
    log("== 8. serving mamba2_370m through build_stack(mode='real')")
    launches.update(serve_path(ops, cfg, model, params, ("ssd_scan",)))
    log("== 9. where the device time goes: the same serving run under torch.profiler")
    serve_path(ops, cfg, model, params, (), profile=True)
    log("== 9b. mamba2_370m preemption, in fp32: the smoke traffic in a block pool too "
        "small for it")
    launches.update(serve_preempted(cfg, model, params, ("ssd_scan",), dtype=torch.float32))
    del model, params
    torch.cuda.empty_cache()

    log("== 10. qwen3_30b_a3b, full width and depth, bf16, random weights (seed 0)")
    cfg, model, params = build_full("qwen3_30b_a3b", expect=30_532_110_336)
    check_model(model, params, cfg.vocab_size)
    check_moe_grouped(cfg, params)
    log("== 11. serving qwen3_30b_a3b through build_stack(mode='real')")
    launches.update(serve_path(ops, cfg, model, params, ("flash_attention", "paged_attention")))
    log("== 12. where the device time goes: the same serving run under torch.profiler")
    serve_path(ops, cfg, model, params, (), profile=True)
    del model, params
    torch.cuda.empty_cache()

    log("== 13. mixtral_8x7b at full width, 16 of its 32 layers, bf16, random weights")
    cfg, model, params = build_full("mixtral_8x7b", layers=16, expect=23_482_470_400)
    check_window_model(cfg, model, params)
    log("== 14. serving one 6144-token prompt past mixtral's 4096-token window")
    launches.update(serve_window(ops, cfg, model, params))
    del model, params
    torch.cuda.empty_cache()

    log("== 15. recurrentgemma_2b, full size, bf16, random weights (seed 0)")
    cfg, model, params = build_full("recurrentgemma_2b", expect=2_894_435_840)
    check_window_model(cfg, model, params, name="recurrentgemma", prompt=3072, chunk=1024,
                       cache=4096, seed=13)
    time_rglru(cfg, params)
    log("== 16. serving recurrentgemma_2b: 4 prompts of 3072 tokens, past its window")
    long_cfg = engine_config(max_num_seqs=4, max_len=4096)
    launches.update(serve_path(ops, cfg, model, params, ("flash_attention", "paged_attention"),
                               reqs=make_requests(4, 3072, 3072, 32, cfg.vocab_size, seed=0),
                               engine_cfg=long_cfg, max_len=4096))
    log("== 17. where the device time goes: the same serving run under torch.profiler")
    serve_path(ops, cfg, model, params, (), profile=True,
               reqs=make_requests(4, 3072, 3072, 32, cfg.vocab_size, seed=0),
               engine_cfg=long_cfg, max_len=4096, ranges=("rglru_scan",))
    del model, params
    torch.cuda.empty_cache()

    log("== 18. whisper_base, full size, bf16, random weights (seed 0)")
    cfg, model, params = build_full("whisper_base", expect=87_405_056)
    check_whisper(cfg, model, params)
    log("== 19. serving whisper_base: 8 text requests, no frames (as the reference)")
    launches.update(serve_path(ops, cfg, model, params, ("flash_attention", "paged_attention"),
                               reqs=make_requests(8, 16, 256, 32, cfg.vocab_size, seed=0),
                               engine_cfg=engine_config(max_num_seqs=8, max_len=512),
                               max_len=512, noncausal=True))
    del model, params
    torch.cuda.empty_cache()

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


def build_full(arch, layers=None, expect=None):
    """``arch`` at full width in bf16 on the card, at full depth or cut to
    ``layers``, random weights from seed 0; its parameter count must equal
    the config's, and ``expect`` where given."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_model
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers, layer_pattern=None)
    model = build_model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"initialised {n_params:,} parameters (config says {cfg.param_count():,}) "
        f"in {time.monotonic() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated")
    if n_params != cfg.param_count() or n_params != (expect or n_params):
        raise AssertionError(f"parameter count {n_params} disagrees with the config "
                             f"({cfg.param_count()}) or the expected {expect}")
    return cfg, model, params


def serve_path(ops, cfg, model, params, path_kernels, profile=False, *, reqs=None,
               engine_cfg=None, max_len=2048, ranges=(), noncausal=False):
    """Serve the smoke traffic (8 requests at once, prompts uniform in
    128-1024 from numpy seed 0, 32 new tokens each; vllm policy, 512-token
    step budget, 8 slots, no prefix caching), or ``reqs`` on ``engine_cfg``,
    through ``build_stack(mode="real")``.  The launch counts are set to 0
    just before the run and read just after; every kernel in
    ``path_kernels`` must have launched, and K1 in every attention layer of
    every prefill chunk.  Returns those kernels' counts.  With ``profile``,
    runs under torch.profiler, with the layer functions named in ``ranges``
    as ranges of their own.  With ``noncausal``, K1 must also have run
    without the causal mask (an enc-dec decoder's cross-attention)."""
    from repro_torch.launch.serve import engine_config, make_requests, run_requests
    from repro_torch.serving.stack import build_stack
    engine_cfg = engine_cfg or engine_config()
    stack = build_stack(cfg, engine_cfg, "real", model=model, params=params,
                        max_len=max_len, device="cuda", dtype=torch.bfloat16)
    if reqs is None:
        reqs = make_requests(SERVING["num"], SERVING["prompt_min"], SERVING["prompt_max"],
                             SERVING["new_tokens"], cfg.vocab_size, seed=SERVING["seed"])
    new_tokens = [r.max_new_tokens for r in reqs]
    if profile:
        profile_serving(lambda: serve_inline(stack, reqs),
                        ranges=ranges or (("moe",) if cfg.moe is not None else ()))
        return {}
    log(f"prompt lengths {[r.prompt_len for r in reqs]}")
    with recording() as rec:
        ops.reset_launch_counts()
        summary = run_requests(stack, reqs, timeout=600)
        counts = ops.launch_counts()
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_pattern)
    if rec.flash:
        log(f"K1 launches by (B, T, S, window, causal): {sorted(rec.flash.items())}")
        if (sum(rec.flash.values()) != counts["flash_attention"]
                or any(n % n_attn for n in rec.flash.values())):
            raise AssertionError(f"K1 did not run in every layer of every prefill chunk: "
                                 f"{dict(rec.flash)} over {n_attn} attention layers")
    if noncausal and not any(not causal for (*_, causal) in rec.flash):
        raise AssertionError(f"K1 never ran without the causal mask: {dict(rec.flash)}")
    steps = summary["steps"]
    log("serving: " + json.dumps(summary))
    log(f"launches during serving: {counts} over {steps} steps ("
        + ", ".join(f"{name} {counts[name] / steps:.2f}" for name in path_kernels)
        + " per step)")
    for r, n in zip(reqs, new_tokens):
        if (r.num_generated != n
                or not all(0 <= t < cfg.vocab_size for t in r.output_tokens)):
            raise AssertionError(f"request {r.request_id} produced {r.num_generated} tokens")
    if summary["finished"] != len(reqs):
        raise AssertionError(f"{summary['finished']} of {len(reqs)} requests finished")
    for name in path_kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the serving path")
    return {name: counts[name] for name in path_kernels}


def serve_inline(stack, reqs) -> None:
    """Serve ``reqs``, all arriving at once, by stepping the engine in the
    calling thread until every one has finished, then shut the stack down.
    The profiled runs use it: torch.profiler records operators and their
    ``record_function`` ranges only in the thread that started it, and the
    engine's own loop runs in a thread of its own."""
    engine = stack.engine
    try:
        now = stack.clock.now()
        for r in reqs:
            r.arrival_time = now
            engine.scheduler.add_request(r)
        while not all(r.finished for r in reqs):
            engine.step()
    finally:
        stack.shutdown()


@contextlib.contextmanager
def recording():
    """Counters of the (B, T, S, window, causal) of every K1 launch
    (``rec.flash``) and of the window of every K2 launch (``rec.paged``)
    while the block runs, taken from shapes and Python arguments (no device
    value is read)."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import paged_attention as paged_mod
    rec = types.SimpleNamespace(flash=collections.Counter(), paged=collections.Counter())
    flash, paged = flash_mod.flash_attention, paged_mod.paged_attention

    def record_flash(q, k, v, **kw):
        rec.flash[(q.shape[0], q.shape[1], k.shape[1], kw.get("window"),
                   kw.get("causal", True))] += 1
        return flash(q, k, v, **kw)

    def record_paged(*args, **kw):
        rec.paged[kw.get("window")] += 1
        return paged(*args, **kw)

    flash_mod.flash_attention, paged_mod.paged_attention = record_flash, record_paged
    try:
        yield rec
    finally:
        flash_mod.flash_attention, paged_mod.paged_attention = flash, paged


def serve_window(ops, cfg, model, params):
    """Phase 14: one request of 6144 prompt tokens and 64 new ones through
    ``build_stack(mode="real")`` in one slot of 8192 positions (512-token
    chunks).  K1 must have run the window on keys past it (S > window) and
    K2 every decode with the window; returns the launch counts."""
    from repro_torch.launch.serve import engine_config, make_requests, run_requests
    from repro_torch.serving.stack import build_stack
    window, prompt, new = cfg.sliding_window, 6144, 64
    stack = build_stack(cfg, engine_config(max_num_seqs=1, max_len=8192), "real",
                        model=model, params=params, max_len=8192, device="cuda",
                        dtype=torch.bfloat16)
    reqs = make_requests(1, prompt, prompt, new, cfg.vocab_size, seed=SERVING["seed"])
    with recording() as rec:
        ops.reset_launch_counts()
        summary = run_requests(stack, reqs, timeout=600)
        counts = ops.launch_counts()
    log("serving: " + json.dumps(summary))
    log(f"K1 launches by (B, T, S, window, causal): {sorted(rec.flash.items())}")
    log(f"K2 launches by window: {dict(rec.paged)}; launches {counts} over "
        f"{summary['steps']} steps")
    req = reqs[0]
    if req.num_generated != new or summary["finished"] != 1:
        raise AssertionError(f"the request produced {req.num_generated} tokens")
    if not any(S > window and w == window for (_, _, S, w, _) in rec.flash):
        raise AssertionError(f"K1 never ran the window past {window} keys: {dict(rec.flash)}")
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_pattern)
    if counts["paged_attention"] != (new - 1) * n_attn:
        raise AssertionError(f"K2 ran {counts['paged_attention']} times for {new - 1} decodes "
                             f"of {n_attn} attention layers")
    if set(rec.paged) != {window}:
        raise AssertionError(f"K2 ran without the window: {dict(rec.paged)}")
    return {name: counts[name] for name in ("flash_attention", "paged_attention")}


def check_window_model(cfg, model, params, *, name="mixtral", prompt=6144, chunk=2048,
                       cache=8192, seed=9):
    """Phase 13 (and 15): logits of a ``prompt``-token prefill in chunks of
    ``chunk`` (the last one's keys past the window) and of a decode at
    position ``prompt``, with K1 and K2 against the plain attention, in
    relative terms as :func:`check_model`; beside them, how far the same
    weights without the window are, to show that the window shaped the
    result."""
    from repro_torch.models.transformer import build_model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt + 1), generator=gen, device="cuda")
    unwindowed = build_model(cfg.replace(sliding_window=None))
    window = cfg.sliding_window

    def run(m, force):
        c = m.init_cache(1, cache, torch.bfloat16, "cuda")
        for a in range(0, prompt, chunk):
            pre, c = m.prefill(params, {"tokens": toks[:, a:a + chunk]}, c, force=force)
        dec, _ = m.decode_step(params, c, toks[:, prompt:], force=force)
        return pre.float(), dec.float()

    with recording() as rec:
        kern = run(model, None)
    plain, wide = run(model, "plain"), run(unwindowed, None)
    torch.cuda.synchronize()
    log(f"K1 launches by (B, T, S, window, causal): {sorted(rec.flash.items())}; K2 by "
        f"window: {dict(rec.paged)}")
    for i, what in enumerate((f"prefill to position {prompt - 1} (K1, window {window})",
                              f"decode at position {prompt} (K2, window {window})")):
        a, b, c = kern[i], plain[i], wide[i]
        if tuple(a.shape) != (1, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"{name} {what}: logits not finite or of the wrong shape")
        rel = float((a - b).abs().max() / b.abs().max())
        rel_wide = float((c - b).abs().max() / b.abs().max())
        log(f"{name} {what}: max relative error kernels vs plain {rel:.3e} (argmax "
            f"{int(a.argmax())} vs {int(b.argmax())}); without the window {rel_wide:.3e}")
        if rel > 5e-2:
            raise AssertionError(f"{name} {what}: kernels and plain differ by {rel}")


def serve_runs(cfg, model, params, engine_cfg, waves, max_len=2048, dtype=torch.bfloat16):
    """Serve ``waves`` of requests through ``build_stack(mode="real")`` (the
    slot cache in ``dtype``), each
    wave arriving when the one before has finished, the engine stepped in
    this thread, the logits of every produced token kept
    (``runner.logits``).  The launch counts are set to 0 just before and
    read just after.  Returns (stack, counts, wall seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.stack import build_stack
    stack = build_stack(cfg, engine_cfg, "real", model=model, params=params, max_len=max_len,
                        device="cuda", dtype=dtype)
    stack.runner.logits = {}
    engine = stack.engine
    try:
        ops.reset_launch_counts()
        t0 = time.monotonic()
        for wave in waves:
            now = stack.clock.now()
            for r in wave:
                r.arrival_time = now
                engine.scheduler.add_request(r)
            while not all(r.finished for r in wave):
                engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = ops.launch_counts()
    finally:
        stack.shutdown()
    return stack, counts, wall


def compare_runs(what, got, got_logits, ref, ref_logits, vocab):
    """Every request of ``got`` must produce the tokens of its twin in
    ``ref``, or, from the first token where bf16 rounding of a differently
    chunked prefill makes them part, that step's logits must lie within
    the relative 5e-2 of the model checks; each parting is logged."""
    parted = []
    for i, (a, b) in enumerate(zip(got, ref)):
        if (a.num_generated != a.max_new_tokens
                or not all(0 <= t < vocab for t in a.output_tokens)):
            raise AssertionError(f"{what}: request {i} produced {a.num_generated} tokens")
        if a.output_tokens == b.output_tokens:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a.output_tokens, b.output_tokens)) if x != y)
        la = got_logits[a.request_id][j].float()
        lb = ref_logits[b.request_id][j].float()
        rel = float((la - lb).abs().max() / lb.abs().max())
        log(f"{what}: request {i} parts at token {j} ({a.output_tokens[j]} against "
            f"{b.output_tokens[j]}); that step's logits differ by {rel:.3e} relative")
        if rel > 5e-2:
            raise AssertionError(f"{what}: request {i}'s logits at token {j} differ by {rel}")
        parted.append(i)
    log(f"{what}: {len(got) - len(parted)} of {len(got)} requests give the same tokens; "
        f"{len(parted)} part, within 5e-2 where they do")


def serve_prefix_hits(cfg, model, params):
    """Phase 6c: 8 requests that share a 1024-token prefix (suffixes of
    64-320 random tokens, 32 new tokens each, torch seed 14): the first one
    is served alone, the other 7 arrive when it has finished, with prefix
    caching on (the runner keeps the cached blocks' KV, 1024 blocks of 16
    positions) and then off.  The cached run must hit (the engine's and the
    prefix cache's counters) and give the uncached run's tokens
    (:func:`compare_runs`).  Returns the cached run's K1 and K2 launches."""
    from repro_torch.launch.serve import engine_config
    from repro_torch.serving.request import Request
    gen = torch.Generator().manual_seed(14)
    prefix = torch.randint(0, cfg.vocab_size, (1024,), generator=gen).tolist()
    suffixes = [torch.randint(0, cfg.vocab_size, (int(n),), generator=gen).tolist()
                for n in torch.randint(64, 321, (8,), generator=gen)]
    runs = {}
    for caching in (True, False):
        reqs = [Request(prompt_tokens=prefix + sfx, max_new_tokens=32) for sfx in suffixes]
        ec = dataclasses.replace(engine_config(), enable_prefix_caching=caching)
        runs[caching] = (reqs,) + serve_runs(cfg, model, params, ec, [reqs[:1], reqs[1:]])
    reqs, stack, counts, wall = runs[True]
    pc = stack.engine.prefix_cache.stats
    store = stack.runner._store
    gib = sum(t.numel() * t.element_size() for t in store.values()) / 2**30
    skipped = sum(r.cached_prefix_len for r in reqs)
    log(f"prefix hits: {pc.device_hits} block hits, {pc.hit_tokens} of {pc.query_tokens} "
        f"prompt tokens from the cache (hit rate {stack.engine.stats()['prefix_hit_rate']:.4f}), "
        f"{skipped} prefill tokens skipped, cached_prefix_len "
        f"{[r.cached_prefix_len for r in reqs]}; store {gib:.2f} GiB "
        f"({stack.engine.cfg.num_blocks} blocks of {stack.engine.cfg.block_size}); "
        f"wall {wall:.3f} s against {runs[False][3]:.3f} s uncached; launches {counts}")
    if pc.device_hits <= 0 or skipped < 7 * 1024:
        raise AssertionError(f"the prefix cache served {skipped} tokens, not 7 x 1024")
    compare_runs("prefix hits against caching off", reqs, stack.runner.logits,
                 runs[False][0], runs[False][1].runner.logits, cfg.vocab_size)
    return {name: counts[name] for name in ("flash_attention", "paged_attention")}


def serve_preempted(cfg, model, params, path_kernels, dtype=torch.bfloat16):
    """Phases 6d and 9b: the smoke traffic of phase 5 (8 requests, 32 new
    tokens each) in a block pool of one block a request more than the
    prompts take, while 32 new tokens take two a request, so that the
    decodes run out and the engine preempts; then in phase 5's pool (1024
    blocks).  The tight run must preempt and give the roomy run's tokens
    (:func:`compare_runs`); ``path_kernels`` must have run in it.  Returns
    their launches in the tight run.  ``dtype`` is the type of the weights
    (bf16 ones are widened to fp32) and of the slot cache.

    mamba2_370m runs in fp32, as :func:`check_mamba` holds its logits: in
    bf16 two runs of the same requests whose decodes are batched
    differently part by more than 5e-2 (6.032e-02 at token 28 of a request
    that was never preempted, on an H100; the bf16 model is 20-36% from the
    fp32 one), which says nothing of the replay."""
    from repro_torch.launch.serve import engine_config, make_requests
    if dtype == torch.float32:
        params = _widen(params)
    roomy = engine_config()
    waves = {}
    for name in ("tight", "roomy"):
        reqs = make_requests(SERVING["num"], SERVING["prompt_min"], SERVING["prompt_max"],
                             SERVING["new_tokens"], cfg.vocab_size, seed=SERVING["seed"])
        need = sum(-(-r.prompt_len // roomy.block_size) for r in reqs)
        tight = dataclasses.replace(roomy, num_blocks=need + len(reqs))
        ec = tight if name == "tight" else roomy
        waves[name] = (reqs,) + serve_runs(cfg, model, params, ec, [reqs], dtype=dtype)
    reqs, stack, counts, wall = waves["tight"]
    stats = stack.engine.stats()
    log(f"preemption: {stats['num_preemptions']} preemptions in a pool of "
        f"{stack.engine.cfg.num_blocks} blocks, requests preempted "
        f"{[r.num_preemptions for r in reqs]}; {stats['steps']} steps in {wall:.3f} s "
        f"against {waves['roomy'][1].engine.stats()['steps']} steps in "
        f"{waves['roomy'][3]:.3f} s unpressured; launches {counts}")
    if stats["num_preemptions"] <= 0:
        raise AssertionError("the tight pool preempted nothing")
    for name in path_kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched in the preempted run")
    compare_runs("preempted against unpressured", reqs, stack.runner.logits,
                 waves["roomy"][0], waves["roomy"][1].runner.logits, cfg.vocab_size)
    return {name: counts[name] for name in path_kernels}


def time_rglru(cfg, params):
    """The RG-LRU recurrence of recurrentgemma_2b (``layers.rglru_scan``,
    fp32, width 2560) at a 512-token prefill chunk (the serving chunk), at
    2048 tokens, and a decode step of 4 rows; and layer 0's whole RG-LRU
    mixer (projections, conv, gates, recurrence) at 512 tokens, bf16."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda").manual_seed(15)
    W = cfg.rglru.lru_width
    for B, T in ((1, 512), (1, 2048), (4, 1)):
        log_a = -0.108 * torch.rand((B, T, W), generator=gen, device="cuda")
        b = torch.randn((B, T, W), generator=gen, device="cuda")
        h0 = torch.randn((B, W), generator=gen, device="cuda")
        ms = time_ms(lambda: L.rglru_scan(log_a, b, h0))
        g_ms = graph_ms(lambda: L.rglru_scan(log_a, b, h0))
        nbytes = 4 * (2 * log_a.numel() + b.numel() + h0.numel())
        log(f"RG-LRU recurrence (B={B}, T={T}, W={W}): {ms:.4f} ms ({g_ms:.4f} in a graph); "
            f"reading its inputs and writing h once would take {nbytes / PEAK_BYTES * 1e3:.5f} ms")
    p = params["blocks"][0]["rglru"]
    x = torch.randn((1, 512, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    layer_ms = time_ms(lambda: L.rglru(cfg, p, x))
    log(f"RG-LRU mixer of layer 0 at a 512-token chunk: {layer_ms:.4f} ms")


def check_whisper(cfg, model, params):
    """Phase 18: ``EncDecLM.prefill`` with 1500 random frame embeddings
    (torch seed 0) and a 64-token prompt, then a decode, with the kernels
    (the encoder and the cross-attention through K1 without the causal
    mask, the decode's cross-attention through K2 over the padded cross
    cache) against the plain attention, in relative terms as
    :func:`check_model`; the encoder alone is timed."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    F = cfg.encoder.max_source_positions
    frames = torch.randn((1, F, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (1, 65), generator=gen, device="cuda")
    results = {}
    for force in (None, "plain"):
        with recording() as rec:
            cache = model.init_cache(1, 512, torch.bfloat16, "cuda")
            pre, cache = model.prefill(params, {"tokens": toks[:, :64], "frontend_embeds": frames},
                                       cache, force=force)
            dec, _ = model.decode_step(params, cache, toks[:, 64:], force=force)
        results[force] = (pre.float(), dec.float())
        if force is None:
            log(f"K1 launches by (B, T, S, window, causal): {sorted(rec.flash.items())}; "
                f"K2: {dict(rec.paged)}; cross cache {tuple(cache['cross_k'].shape)} for "
                f"{cache['cross_frames']} frames")
            if not any(S == F and not causal for (_, _, S, _, causal) in rec.flash):
                raise AssertionError("K1 never ran the encoder or the cross-attention")
    torch.cuda.synchronize()
    for i, what in enumerate(("prefill (encoder over 1500 frames, 64 tokens)",
                              "decode (cross-attention over 1500 frames, K2)")):
        a, b = results[None][i], results["plain"][i]
        if tuple(a.shape) != (1, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"whisper {what}: logits not finite or of the wrong shape")
        rel = float((a - b).abs().max() / b.abs().max())
        log(f"whisper {what}: max relative error kernels vs plain {rel:.3e} "
            f"(argmax {int(a.argmax())} vs {int(b.argmax())})")
        if rel > 5e-2:
            raise AssertionError(f"whisper {what}: kernels and plain differ by {rel}")
    enc_ms = time_ms(lambda: model.encode(params, frames), iters=5)
    log(f"whisper encoder over {F} frames: {enc_ms:.4f} ms")


def check_moe_grouped(cfg, params):
    """The MoE of layer 0 of qwen3_30b_a3b on a 512-token chunk in bf16: the
    grouped call (``torch._grouped_mm``) against the per-expert loop, for
    the whole layer and for the first product alone (2e-2), and both timed;
    the router's expert loads beside them."""
    from repro_torch.models import layers as L
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((1, 512, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    y, aux = L.moe(cfg, p, x)
    y_loop, _ = L.moe(cfg, p, x, force="plain")
    torch.cuda.synchronize()
    err = assert_close("MoE layer 0 grouped vs per-expert loop (1, 512) bfloat16", y, y_loop,
                       "bfloat16")
    _, _, idx = L.moe_route(cfg, p, x.reshape(-1, cfg.d_model))
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    xs = x.reshape(-1, cfg.d_model)[order // cfg.moe.top_k]
    sizes = torch.bincount(flat, minlength=cfg.moe.num_experts).int()
    assert_close("MoE w_in product grouped vs loop bfloat16", L.grouped_mm(xs, p["w_in"], sizes),
                 L.grouped_mm_loop(xs, p["w_in"], sizes), "bfloat16")
    ms = time_ms(lambda: L.grouped_mm(xs, p["w_in"], sizes))
    g_ms = graph_ms(lambda: L.grouped_mm(xs, p["w_in"], sizes))
    loop_ms = time_ms(lambda: L.grouped_mm_loop(xs, p["w_in"], sizes))
    layer_ms = time_ms(lambda: L.moe(cfg, p, x))
    loop_layer_ms = time_ms(lambda: L.moe(cfg, p, x, force="plain"))
    rows, (E, d, n) = xs.shape[0], p["w_in"].shape
    nbytes = 2 * (xs.numel() + rows * n + int((sizes > 0).sum()) * d * n)
    b_ms, b_by = bound(2 * rows * d * n, nbytes, PEAK_BF16_FLOPS)
    load = sizes.tolist()
    log(f"MoE layer 0: {sum(1 for s in load if s == 0)} of {E} experts got no token, the "
        f"largest {max(load)} rows; max abs err {err:.3e}; w_in product grouped "
        f"{ms:.4f} ms ({g_ms:.4f} in a graph), loop {loop_ms:.4f} ms, bound {b_ms:.5f} ms by "
        f"{b_by}; whole layer grouped {layer_ms:.4f} ms, loop {loop_layer_ms:.4f} ms; "
        f"aux loss {float(aux['moe_aux_loss']):.4f}")


def real_against_emulated(cfg, model, params) -> None:
    """Phase 6b: ``real_vs_emulated.run`` on the card, with the facts that
    can fail checked here; the sizes of the errors are printed only."""
    from repro_torch.launch import real_vs_emulated as rve
    t0 = time.monotonic()
    report = rve.run(cfg, model, params, device="cuda", dtype=torch.bfloat16,
                     timeout=300)
    for line in rve.format_report(report):
        log("  " + line)
    log("real_vs_emulated: " + json.dumps(report))
    for key in ("calibration", "real"):
        launched = report[key]["launches"]
        if launched["flash_attention"] <= 0 or launched["paged_attention"] <= 0:
            raise AssertionError(f"{key}: K1 or K2 never launched: {launched}")
        if report[key]["num_requests"] != rve.STREAM["num_requests"]:
            raise AssertionError(f"{key}: {report[key]['num_requests']} requests finished")
    for key in ("emulate_linear", "emulate_analytical"):
        r = report[key]
        if any(r["launches"].values()):
            raise AssertionError(f"{key} launched kernels: {r['launches']}")
        if r["allocated_delta_bytes"] != 0:
            raise AssertionError(f"{key} changed the allocated device memory by "
                                 f"{r['allocated_delta_bytes']} bytes")
        if r["num_requests"] != rve.STREAM["num_requests"]:
            raise AssertionError(f"{key}: {r['num_requests']} requests finished")
        if not r["wall_s"] < report["real"]["wall_s"]:
            raise AssertionError(f"{key} took {r['wall_s']} s of wall time, the real "
                                 f"run {report['real']['wall_s']} s")
    log(f"phase 6b took {time.monotonic() - t0:.1f} s")


def profile_serving(serve, ranges=()) -> None:
    """Device time by kernel over one ``serve()`` call, and the device's busy
    share of the wall time (one stream, so kernels do not overlap).  Each
    function of ``repro_torch.models.layers`` named in ``ranges`` (``moe``,
    ``rglru_scan``) runs inside a ``record_function`` range of its name, and
    operators are recorded too: a range's device time is that of every
    kernel launched inside it (for the MoE: routing, sort, gather, the
    grouped products, named ``*group*``, the activation and the scatter-add;
    for the RG-LRU recurrence, its elementwise kernels and reductions).
    (Without ranges only the device is traced: turning a serving run's
    operator records into events costs about a minute of host time.)"""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import layers as L
    originals = {name: getattr(L, name) for name in ranges}

    def in_range(name, fn):
        def wrapped(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return wrapped

    for name, fn in originals.items():
        setattr(L, name, in_range(name, fn))
    try:
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
        with profile(activities=activities, acc_events=True) as prof:
            t0 = time.monotonic()
            serve()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        for name, fn in originals.items():
            setattr(L, name, fn)
    # the ranges: operator events of this thread, whose device time is that
    # of every kernel launched inside them
    in_ranges = collections.defaultdict(lambda: [0.0, 0])
    for e in (prof.events() if ranges else ()):
        if e.name in originals and e.device_type == torch.autograd.DeviceType.CPU:
            in_ranges[e.name][0] += e.device_time_total / 1e3
            in_ranges[e.name][1] += 1
    kernels = []
    for evt in prof.key_averages():
        # a range's device-side annotation spans kernels; it is none itself
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.key in originals:
            continue
        ms = getattr(evt, "self_device_time_total", 0) / 1e3
        if ms > 0:
            kernels.append((ms, evt.count, evt.key))
    total = sum(ms for ms, _, _ in kernels)
    if not kernels:
        log("profiler saw no device time")
        return
    groups = {"flash_attention (K1)": 0.0, "paged_attention (K2)": 0.0,
              "ssd_scan (K3)": 0.0, "MoE grouped products": 0.0, "matrix products": 0.0,
              "other": 0.0}
    for ms, _, name in kernels:
        low = name.lower()
        if "group" in low:
            groups["MoE grouped products"] += ms
        elif "flash_fwd" in name:
            groups["flash_attention (K1)"] += ms
        elif "paged_fwd" in name:
            groups["paged_attention (K2)"] += ms
        elif "ssd_fwd" in name:
            groups["ssd_scan (K3)"] += ms
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")):
            groups["matrix products"] += ms
        else:
            groups["other"] += ms
    log(f"wall {wall_ms:.1f} ms under the profiler (engine stepped in this thread), "
        f"device busy {total:.1f} ms "
        f"({100 * total / wall_ms:.1f}%), idle {100 * (1 - total / wall_ms):.1f}%")
    for g, ms in groups.items():
        log(f"  {g:24s} {ms:9.2f} ms  {100 * ms / total:5.1f}% of device time")
    if "moe" in in_ranges:
        moe_ms, moe_calls = in_ranges["moe"]
        log(f"  MoE layers, all their kernels ({moe_calls} calls): {moe_ms:.2f} ms, "
            f"{100 * moe_ms / total:.1f}% of device time; routing, dispatch and combine "
            f"{moe_ms - groups['MoE grouped products']:.2f} ms")
    if "rglru_scan" in in_ranges:
        scan_ms, scan_calls = in_ranges["rglru_scan"]
        log(f"  RG-LRU recurrence, all its kernels ({scan_calls} calls): {scan_ms:.2f} ms, "
            f"{100 * scan_ms / total:.1f}% of device time (within \"other\"); the rest of "
            f"\"other\" {groups['other'] - scan_ms:.2f} ms")
    for ms, n, name in sorted(kernels, reverse=True)[:10]:
        log(f"  {ms:9.2f} ms  x{n:<6d} {name[:110]}")


def _widen(tree):
    """The same tree with every tensor in fp32."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_widen(v) for v in tree]
    return tree.float()


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
