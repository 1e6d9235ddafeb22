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
   shape grids of ``tests/test_kernels.py`` and at the llama3_8b shapes
   (tolerance 2e-4 in fp32, 2e-2 in bf16), and times kernel, plain version
   and one library call at the llama3_8b shapes;
4. builds llama3_8b at full width and depth in bf16 from a seeded generator
   on the card and compares its prefill and decode logits with the kernels
   against the same calls with the plain attention;
5. serves 8 requests (prompts of 128-1024 tokens, 32 new tokens each)
   through ``build_stack(mode="real")``, with every kernel launch count set
   to 0 just before and read just after, and checks that every request got
   its 32 tokens and that both kernels ran;
6. serves the same requests again under ``torch.profiler`` and prints the
   device time by kernel and the device's busy and idle shares.

It prints one JSON ``kernels`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and the exit
code is not 0; without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

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

def assert_close(name, out, exp, dtype_name):
    tol = TOL[dtype_name]
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
    for shape, dt, kw in cases:
        q, k, v = qkv(gen, *shape, getattr(torch, dt))
        out = ops.flash_attention(q, k, v, **kw)
        exp = ops.flash_attention(q, k, v, force="plain", **kw)
        torch.cuda.synchronize()
        assert_close(f"K1 {shape} {dt} {kw}", out, exp, dt)


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


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def measure_flash(ops):
    """K1 at the llama3_8b prefill shape: one 512-token chunk after 512
    cached tokens."""
    B, T, S, Hq, Hkv, D = 1, 512, 1024, 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = qkv(gen, B, T, S, Hq, Hkv, D, torch.bfloat16)
    out = ops.flash_attention(q, k, v)
    exp = ops.flash_attention(q, k, v, force="plain")
    torch.cuda.synchronize()
    err = assert_close(f"K1 llama3_8b {(B, T, S, Hq, Hkv, D)} bfloat16", out, exp, "bfloat16")
    ms = time_ms(lambda: ops.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: ops.flash_attention(q, k, v, force="plain"))
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
    pairs = sum(min(S, i + (S - T) + 1) for i in range(T))
    flops = 4 * D * Hq * B * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"K1 llama3_8b: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms "
        f"(SDPA vs plain max abs err {lib_err:.3e}), bound {b_ms:.5f} ms by {b_by} "
        f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB); "
        f"fp32-core bound {flops / PEAK_FP32_FLOPS * 1e3:.5f} ms")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:109",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


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
    ctx = int(cl.sum())
    flops = 4 * Hq * D * ctx
    nbytes = 2 * (q.numel() + out.numel()) + 2 * 2 * ctx * Hkv * D + 4 * (bt.numel() + B)
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"K2 llama3_8b: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms "
        f"(SDPA vs plain max abs err {lib_err:.3e}), bound {b_ms:.5f} ms by {b_by} "
        f"({nbytes / 1e6:.3f} MB, contexts {cl.tolist()})")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:88",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


# -------------------------------------------------------------------------
# 4. model check
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


# -------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import make_requests, run_requests
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.scheduler import EngineConfig
    from repro_torch.serving.stack import build_stack

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
    kernels = [measure_flash(ops), measure_paged(ops)]

    log("== 4. llama3_8b, full width and depth, bf16, random weights (seed 0)")
    cfg = get_config("llama3_8b")
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
    check_model(model, params, cfg.vocab_size)

    log("== 5. serving through build_stack(mode='real')")
    engine_cfg = EngineConfig(policy="vllm", max_num_seqs=8, max_batched_tokens=512,
                              block_size=16, num_blocks=1024, enable_prefix_caching=False,
                              chip="h100-sxm")
    stack = build_stack(cfg, engine_cfg, "real", model=model, params=params,
                        max_len=2048, device="cuda", dtype=torch.bfloat16)
    reqs = make_requests(8, 128, 1024, 32, cfg.vocab_size, seed=0)
    log(f"prompt lengths {[r.prompt_len for r in reqs]}")
    ops.reset_launch_counts()
    summary = run_requests(stack, reqs, timeout=600)
    counts = ops.launch_counts()
    steps = summary["steps"]
    log("serving: " + json.dumps(summary))
    log(f"launches during serving: {counts} over {steps} steps "
        f"({counts['flash_attention'] / steps:.2f} and "
        f"{counts['paged_attention'] / steps:.2f} per step)")
    for r in reqs:
        if r.num_generated != 32 or not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"request {r.request_id} produced {r.num_generated} tokens")
    if summary["finished"] != len(reqs):
        raise AssertionError(f"{summary['finished']} of {len(reqs)} requests finished")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the serving path")
    for k in kernels:
        k["launches"] = counts[k["name"]]
        log(f"kernel {k['name']}: {k['ms']:.4f} ms a call, {k['launches']} launches "
            f"({k['launches'] / steps:.2f} per serving step), bound {k['bound_ms']:.5f} ms "
            f"by {k['bound_by']}, plain {k['plain_ms']:.4f} ms, library "
            f"{k['library_ms']:.4f} ms, max abs err {k['max_abs_err']:.3e}")

    log("== 6. where the device time goes: the same serving run under torch.profiler")
    stack = build_stack(cfg, engine_cfg, "real", model=model, params=params,
                        max_len=2048, device="cuda", dtype=torch.bfloat16)
    reqs = make_requests(8, 128, 1024, 32, cfg.vocab_size, seed=0)
    profile_serving(lambda: run_requests(stack, reqs, timeout=600))

    log(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


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
              "matrix products": 0.0, "other": 0.0}
    for ms, _, name in kernels:
        low = name.lower()
        if "flash_fwd" in name:
            groups["flash_attention (K1)"] += ms
        elif "paged_fwd" in name:
            groups["paged_attention (K2)"] += ms
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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
