"""The port's CUDA kernels on the card against their plain versions, and the
reduced models with the kernels against the same models with the plain
versions.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` (they build the
kernels) and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it also runs where JAX is not
installed.  Tolerances: 2e-4 in fp32, 2e-2 in bf16 (``tests/test_kernels.py``;
5e-4 at the SSD property points, as there).
"""

import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.models.transformer import build_model

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,kw", [
    (2, 128, 256, 8, 2, 64, {}), (1, 100, 100, 2, 2, 64, {}), (1, 33, 126, 4, 1, 128, {}),
    (1, 8, 8, 1, 1, 32, {}), (1, 128, 128, 4, 2, 64, {"window": 16}),
    (2, 64, 80, 4, 4, 64, {"causal": False})])
def test_flash_kernel_matches_plain(gen, B, T, S, Hq, Hkv, D, kw, dtype):
    q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == 1
    exp = ops.flash_attention(q, k, v, force="plain", **kw)
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,kw", [
    (1, 512, 1024, 16, 2, 128, {}),                 # G = 8 at D = 128 (qwen2_5_3b's widths)
    (2, 77, 300, 16, 2, 128, {}),
    (1, 200, 260, 8, 2, 64, {"window": 48}),        # windows with G > 1
    (1, 129, 400, 32, 8, 128, {"window": 100}),
    (1, 45, 173, 32, 8, 128, {}),                   # T and S - T off the tile grids
    (1, 333, 1000, 4, 1, 32, {}), (2, 150, 301, 12, 4, 64, {}),
    (1, 97, 97, 6, 1, 32, {})])                     # G = 6: packs of 2
def test_flash_bf16_kernel_packing(gen, B, T, S, Hq, Hkv, D, kw):
    """The bf16 kernel's GQA-packed tiles and edge masks against the plain
    version and the plain tiled decomposition."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref
    q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == 1
    p = flash_mod.plan(B, T, S, Hq, Hkv, D)
    for exp in (ops.flash_attention(q, k, v, force="plain", **kw),
                ref.flash_attention_tiled(q, k, v, block_rows=p.block_rows,
                                          block_keys=p.block_keys, **kw)):
        torch.testing.assert_close(out.float(), exp.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("block_rows,block_keys", [(64, 64), (64, 128), (128, 64)])
def test_flash_bf16_kernel_every_tile(gen, block_rows, block_keys, monkeypatch):
    """Each tile choice the kernel is built for, on a ragged GQA shape with
    a window, against the plain version."""
    import functools

    from repro_torch.kernels import flash_attention as flash_mod
    monkeypatch.setattr(flash_mod, "plan", functools.partial(
        flash_mod.plan, block_rows=block_rows, block_keys=block_keys))
    for D in (32, 64, 128):
        q = torch.randn((2, 150, 16, D), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((2, 333, 4, D), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((2, 333, 4, D), generator=gen, device="cuda").to(torch.bfloat16)
        for kw in ({}, {"window": 70}):
            torch.testing.assert_close(ops.flash_attention(q, k, v, **kw).float(),
                                       ops.flash_attention(q, k, v, force="plain", **kw).float(),
                                       rtol=2e-2, atol=2e-2)


def test_flash_bf16_kernel_takes_slot_cache_views(gen):
    """K and V as B=2 views of a larger slot cache, as the model passes
    k_c[:, :s1]; a batch stride TMA cannot take raises."""
    cache = torch.randn((2, 3, 2048, 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn((2, 200, 32, 128), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = cache[0, 1:, :456], cache[1, 1:, :456]
    torch.testing.assert_close(ops.flash_attention(q, k, v).float(),
                               ops.flash_attention(q, k, v, force="plain").float(),
                               rtol=2e-2, atol=2e-2)
    flat = torch.randn(2 * (8 * 8 * 32 + 4), generator=gen, device="cuda").to(torch.bfloat16)
    odd = flat.view(2, -1)[:, :8 * 8 * 32].view(2, 8, 8, 32)
    with pytest.raises(ValueError, match="batch stride"):
        ops.flash_attention(odd, odd, odd)


def test_flash_kernel_custom_scale(gen):
    """fp32 only, as in tests/test_kernels.py: at scale 0.5 the bf16 plain
    version, which rounds q.k to bf16 before scaling, is itself more than
    2e-2 from exact."""
    q, k, v = (torch.randn((1, 64, 2, 64), generator=gen, device="cuda") for _ in range(3))
    torch.testing.assert_close(ops.flash_attention(q, k, v, softmax_scale=0.5),
                               ops.flash_attention(q, k, v, softmax_scale=0.5, force="plain"),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,page,pps", [(3, 8, 2, 64, 16, 3), (1, 4, 1, 128, 32, 2),
                                                 (4, 2, 2, 32, 8, 5)])
def test_paged_kernel_matches_plain(gen, B, Hq, Hkv, D, page, pps, dtype):
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(dtype)
    tables = torch.randperm(B * pps, generator=gen, device="cuda").int().view(B, pps)
    ctx = torch.randint(1, page * pps + 1, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    ops.reset_launch_counts()
    out = ops.paged_attention(q, kp, vp, tables, ctx)
    assert ops.launch_counts()["paged_attention"] == 1
    exp = ops.paged_attention(q, kp, vp, tables, ctx, force="plain")
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_partition_edges(gen, dtype):
    """Contexts of 0, 1, one partition, one key past it and the whole table
    over scattered tables: against the plain version and the plain
    split-and-merge (an empty context gives 0)."""
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels import ref
    part, page, pps = paged_mod.PARTITION, 16, 40
    B, Hq, Hkv, D = 5, 8, 2, 64
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((B * pps + 7, page, Hkv, D), generator=gen, device="cuda").to(dtype)
    vp = torch.randn(kp.shape, generator=gen, device="cuda").to(dtype)
    tables = torch.randperm(kp.shape[0], generator=gen, device="cuda")[:B * pps]
    tables = tables.int().view(B, pps).contiguous()
    ctx = torch.tensor([0, 1, part, part + 1, page * pps], dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    out = ops.paged_attention(q, kp, vp, tables, ctx)
    assert ops.launch_counts()["paged_attention"] == 1
    assert float(out[0].abs().max()) == 0.0
    exp = ops.paged_attention(q, kp, vp, tables, ctx, force="plain")
    torch.testing.assert_close(out[1:].float(), exp[1:].float(), rtol=TOL[dtype], atol=TOL[dtype])
    split = ref.paged_attention_split(q, kp, vp, tables, ctx)
    torch.testing.assert_close(out.float(), split.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [1, 15, 16, 64, 1000])
def test_paged_kernel_window(gen, window, dtype):
    """K2's sliding window against the plain version and the plain
    split-and-merge, contexts on both sides of partition edges."""
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels import ref
    part, page, pps = paged_mod.PARTITION, 16, 12
    B, Hq, Hkv, D = 6, 8, 2, 64
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(dtype)
    vp = torch.randn(kp.shape, generator=gen, device="cuda").to(dtype)
    tables = torch.randperm(B * pps, generator=gen, device="cuda").int().view(B, pps)
    ctx = torch.tensor([1, part - 1, part, part + 1, 2 * part + 3, page * pps],
                       dtype=torch.int32, device="cuda")
    out = ops.paged_attention(q, kp, vp, tables, ctx, window=window)
    exp = ops.paged_attention(q, kp, vp, tables, ctx, window=window, force="plain")
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])
    split = ref.paged_attention_split(q, kp, vp, tables, ctx, window=window)
    torch.testing.assert_close(out.float(), split.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_moe_window_model_with_kernels_matches_plain(gen):
    """Reduced mixtral_8x7b (MoE, window 64) at D=32 in bf16: prefill past
    the window in two chunks and a decode, K1, K2 and the grouped products
    against the plain attention and the per-expert loop."""
    cfg = get_reduced_config("mixtral_8x7b").replace(head_dim=32, d_model=128)
    model = build_model(cfg)
    params = model.init(gen, torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (1, 151), generator=gen, device="cuda")
    logits = {}
    for force in (None, "plain"):
        cache = model.init_cache(1, 160, torch.bfloat16)
        a, cache = model.prefill(params, {"tokens": toks[:, :40]}, cache, force=force)
        b, cache = model.prefill(params, {"tokens": toks[:, 40:150]}, cache, force=force)
        c, cache = model.decode_step(params, cache, toks[:, 150:], force=force)
        logits[force] = [t.float() for t in (a, b, c)]
    for got, exp in zip(logits[None], logits["plain"]):
        assert float((got - exp).abs().max() / exp.abs().max()) < 5e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,kw", [
    (1, 512, 3072, 10, 1, 256, {"window": 2048}),   # recurrentgemma_2b's local attention
    (1, 300, 300, 10, 1, 256, {"window": 64}), (2, 77, 190, 10, 1, 256, {}),
    (1, 1500, 1500, 8, 8, 64, {"causal": False}),   # whisper_base's encoder
    (1, 64, 1500, 8, 8, 64, {"causal": False})])    # and its cross-attention
def test_flash_kernel_at_head_dim_256_and_non_causal(gen, B, T, S, Hq, Hkv, D, kw, dtype):
    q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    out = ops.flash_attention(q, k, v, **kw)
    exp = ops.flash_attention(q, k, v, force="plain", **kw)
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,D,window", [(10, 256, 2048), (10, 256, None), (16, 256, 100),
                                         (32, 128, None)])
def test_paged_kernel_at_large_groups(gen, Hq, D, window, dtype):
    """G * D of 2560 (recurrentgemma_2b) and 4096, the most the kernel takes,
    which opt in to more than 48 KB of shared memory."""
    B, page, pps = 3, 16, 192
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((B * pps, page, 1, D), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((B * pps, page, 1, D), generator=gen, device="cuda").to(dtype)
    tables = torch.randperm(B * pps, generator=gen, device="cuda").to(torch.int32).view(B, pps)
    ctx = torch.tensor([3072, 2049, 700], dtype=torch.int32, device="cuda")
    out = ops.paged_attention(q, kp, vp, tables, ctx, window=window)
    exp = ops.paged_attention(q, kp, vp, tables, ctx, window=window, force="plain")
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "whisper_base"])
def test_rglru_and_encdec_models_with_kernels_match_plain(gen, arch):
    """Reduced recurrentgemma_2b (RG-LRU, local attention past its window of
    64) and whisper_base (a prefill with frames: the encoder and the
    cross-attention through K1 non-causal; decodes through K2 over the cross
    cache) in fp32: logits with the kernels equal the plain attention's
    within 2e-3.  At head_dim 32: the reduced configs' 16 is below the
    kernels' smallest, and K1 raises on it."""
    cfg = get_reduced_config(arch).replace(head_dim=32, d_model=128)
    model = build_model(cfg)
    params = model.init(gen, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (1, 101), generator=gen, device="cuda")
    frames = torch.randn((1, cfg.encoder.max_source_positions, cfg.d_model), generator=gen,
                         device="cuda") if cfg.encoder else None
    logits = {}
    for force in (None, "plain"):
        cache = model.init_cache(1, 128, torch.float32)
        first = {"tokens": toks[:, :40]}
        if frames is not None:
            first["frontend_embeds"] = frames
        a, cache = model.prefill(params, first, cache, force=force)
        b, cache = model.prefill(params, {"tokens": toks[:, 40:100]}, cache, force=force)
        c, cache = model.decode_step(params, cache, toks[:, 100:], force=force)
        logits[force] = (a, b, c)
    for got, exp in zip(logits[None], logits["plain"]):
        torch.testing.assert_close(got, exp, rtol=2e-3, atol=2e-3)


def test_model_with_kernels_matches_plain(gen):
    """Reduced llama3_8b in fp32: prefill, chunked prefill and decode logits
    with the kernels equal the plain attention's within 2e-3."""
    cfg = get_reduced_config("llama3_8b").replace(head_dim=32, d_model=128)
    model = build_model(cfg)
    params = model.init(gen, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=gen, device="cuda")
    logits = {}
    for force in (None, "plain"):
        cache = model.init_cache(2, 64, torch.float32)
        a, cache = model.prefill(params, {"tokens": toks[:, :24]}, cache, force=force)
        b, cache = model.prefill(params, {"tokens": toks[:, 24:40]}, cache, force=force)
        c, cache = model.decode_step(params, cache, toks[:, 40:], force=force)
        logits[force] = (a, b, c)
    for got, exp in zip(logits[None], logits["plain"]):
        torch.testing.assert_close(got, exp, rtol=2e-3, atol=2e-3)


def _ssd_inputs(gen, B, T, H, P, N, dtype):
    xdt = torch.randn((B, T, H, P), generator=gen, device="cuda")
    dA = -torch.nn.functional.softplus(torch.randn((B, T, H), generator=gen, device="cuda"))
    Bm = torch.randn((B, T, N), generator=gen, device="cuda")
    Cm = torch.randn((B, T, N), generator=gen, device="cuda")
    return [t.to(dtype) for t in (xdt, dA, Bm, Cm)]


@pytest.mark.parametrize("B,T,H,P,N,chunk,dtype,tol,carry", [
    (1, 128, 2, 64, 32, 128, torch.float32, 2e-4, False),
    (2, 256, 2, 64, 32, 128, torch.float32, 2e-4, False),
    (2, 64, 4, 16, 16, 32, torch.float32, 2e-4, False),
    (1, 96, 2, 32, 32, 32, torch.float32, 2e-4, False),
    (1, 192, 3, 32, 32, 64, torch.float32, 5e-4, False),
    (2, 37, 2, 16, 16, 16, torch.float32, 2e-4, True),        # ragged, carried state
    (1, 379, 4, 64, 128, 128, torch.float32, 2e-4, True),     # mamba2 widths, ragged
    (2, 300, 32, 64, 128, 128, torch.float32, 2e-4, True),    # two chunks and a tail
    (1, 17, 3, 48, 20, 16, torch.float32, 2e-4, True),        # N not a multiple of 16
    (3, 2000, 4, 32, 32, 32, torch.float32, 2e-4, True),      # 63 chunks: the look-back
    (1, 128, 2, 32, 32, 64, torch.bfloat16, 2e-2, True)])
def test_ssd_kernel_matches_plain(gen, B, T, H, P, N, chunk, dtype, tol, carry):
    xdt, dA, Bm, Cm = _ssd_inputs(gen, B, T, H, P, N, dtype)
    s0 = torch.randn((B, H, N, P), generator=gen, device="cuda") if carry else None
    ops.reset_launch_counts()
    y, state = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=chunk, initial_state=s0)
    assert ops.launch_counts()["ssd_scan"] == 1
    y_exp, s_exp = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=chunk, initial_state=s0, force="plain")
    torch.testing.assert_close(y, y_exp, rtol=tol, atol=tol)
    torch.testing.assert_close(state, s_exp, rtol=tol, atol=tol)


@pytest.mark.parametrize("H", [8, 2])
def test_ssd_kernel_at_a_ranks_heads(gen, H):
    """K3 at a tensor-parallel rank's heads of mamba2_370m (8 of 32 at 4
    "model" ranks, 2 at 16): two rows of 1000 tokens, a ragged last chunk,
    from a carried state, against ``ref.ssd_scan_chunked``."""
    from repro_torch.kernels import ref
    xdt, dA, Bm, Cm = _ssd_inputs(gen, 2, 1000, H, 64, 128, torch.float32)
    s0 = torch.randn((2, H, 128, 64), generator=gen, device="cuda")
    ops.reset_launch_counts()
    y, state = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=128, initial_state=s0)
    assert ops.launch_counts()["ssd_scan"] == 1
    y_exp, s_exp = ref.ssd_scan_chunked(xdt, dA, Bm, Cm, chunk=128, initial_state=s0)
    torch.testing.assert_close(y, y_exp, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(state, s_exp, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_ssd_kernel_every_column_tile(gen, tile, monkeypatch):
    """Each tile of state columns a block may own, on a ragged T with a
    carried state, against the plain two passes and the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    monkeypatch.setattr(ssd_mod, "col_tile", lambda *_: tile)
    xdt, dA, Bm, Cm = _ssd_inputs(gen, 1, 331, 8, 64, 128, torch.float32)
    s0 = torch.randn((1, 8, 128, 64), generator=gen, device="cuda")
    y, state = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=128, initial_state=s0)
    for y_exp, s_exp in (ops.ssd_scan(xdt, dA, Bm, Cm, chunk=128, initial_state=s0,
                                      force="plain"),
                         ref.ssd_scan_two_pass(xdt, dA, Bm, Cm, chunk=128, initial_state=s0)):
        torch.testing.assert_close(y, y_exp, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(state, s_exp, rtol=2e-4, atol=2e-4)


def test_ssd_kernel_takes_strided_views(gen):
    """B and C as slices of one projection, as the SSD layer hands them over."""
    proj = torch.randn((2, 40, 64 + 2 * 32), generator=gen, device="cuda")
    Bm, Cm = proj[..., 64:96], proj[..., 96:]
    xdt, dA, _, _ = _ssd_inputs(gen, 2, 40, 4, 16, 32, torch.float32)
    torch.testing.assert_close(ops.ssd_scan(xdt, dA, Bm, Cm, chunk=32),
                               ops.ssd_scan(xdt, dA, Bm, Cm, chunk=32, force="plain"),
                               rtol=2e-4, atol=2e-4)


SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _grad_scales(exp):
    """Each gradient's largest entry; for one that is zero in exact
    arithmetic (under 1e-6 of the largest over all the call's gradients, as
    ddA at T = 1 without an initial state) 1e-1 of that largest, so that it
    is still held to rounding (chip_smoke.py's ``grad_scales`` says why)."""
    own = [float(e.abs().max()) for e in exp]
    return [m if m > 1e-6 * max(own) else 1e-1 * max(own) for m in own]


def _ssd_grads(xs, s0, dy, d_final, chunk, force=None):
    ins = [t.detach().requires_grad_() for t in xs]
    if s0 is not None:
        ins.append(s0.detach().requires_grad_())
    y, st = ops.ssd_scan(*ins[:4], chunk=chunk, initial_state=ins[4] if s0 is not None else None,
                         force=force)
    outs, gouts = [y], [dy]
    if d_final is not None:
        outs.append(st)
        gouts.append(d_final)
    return torch.autograd.grad(outs, ins, gouts)


SSD_BWD_CASES = ([(T, N, P, 128, torch.float32, both, both) for T in (16, 100, 512, 2048)
                  for N in (16, 128) for P in (16, 64) for both in (False, True)]
                 + [(300, 128, 64, 128, torch.float32, True, False),
                    (300, 128, 64, 128, torch.float32, False, True),
                    (200, 32, 32, 64, torch.float32, True, True),
                    (37, 16, 16, 16, torch.float32, True, True),
                    (300, 128, 64, 128, torch.bfloat16, True, True)]
                 # the edges of the 3xTF32 tiles: N padded to the mma's 8 columns,
                 # P in tiles of 16, chunks of 16-48, T = 1, Q + 1, 2Q - 1
                 + [(T, N, 16, 128, torch.float32, True, True)
                    for T, N in ((100, 4), (129, 8), (255, 12), (200, 100))]
                 + [(129, 128, 48, 128, torch.float32, True, False),
                    (47, 8, 48, 16, torch.float32, False, True),
                    (63, 12, 16, 32, torch.float32, True, True),
                    (95, 100, 32, 48, torch.float32, True, True),
                    (1, 4, 16, 128, torch.float32, True, True),
                    (1, 128, 64, 32, torch.float32, True, True),
                    (1, 128, 64, 32, torch.float32, False, True),
                    (33, 16, 16, 32, torch.float32, True, True),
                    (63, 64, 48, 32, torch.float32, False, False),
                    (129, 12, 48, 128, torch.bfloat16, True, True)])


@pytest.mark.parametrize("T,N,P,chunk,dtype,init,final", SSD_BWD_CASES)
def test_ssd_bwd_kernel_matches_plain(gen, T, N, P, chunk, dtype, init, final):
    """K3-bwd through ``ops.ssd_scan``'s autograd against the plain
    decomposition (``ref.ssd_scan_bwd_two_pass``) and against autograd
    through the plain scan on the same values in fp32 (chip_smoke.py's
    phase 3f grid): each gradient within 1e-4 (fp32) or 1e-2 (bf16) of its
    largest entry (``_grad_scales``: at T = 1 without an initial state ddA
    is 0)."""
    from repro_torch.kernels import ref
    xs = _ssd_inputs(gen, 2, T, 4, P, N, dtype)
    s0 = torch.randn((2, 4, N, P), generator=gen, device="cuda") if init else None
    dy = torch.randn((2, T, 4, P), generator=gen, device="cuda")
    d_final = torch.randn((2, 4, N, P), generator=gen, device="cuda") if final else None
    ops.reset_launch_counts()
    got = _ssd_grads(xs, s0, dy, d_final, chunk)
    counts = ops.launch_counts()
    assert (counts["ssd_scan"], counts["ssd_scan_bwd"]) == (1, 1)
    xf = [x.float() for x in xs]
    two = [g for g in ref.ssd_scan_bwd_two_pass(*xf, dy, chunk=chunk, initial_state=s0,
                                                 d_final=d_final) if g is not None]
    for exp in (two, _ssd_grads(xf, s0, dy, d_final, chunk, force="plain")):
        assert len(got) == len(exp)
        for g, e, scale in zip(got, exp, _grad_scales(exp)):
            assert torch.isfinite(g).all()
            assert float((g.float() - e).abs().max()) <= SSD_BWD_TOL[dtype] * scale


@pytest.mark.parametrize("T,H", [(200, 1), (1024, 10)])
def test_ssd_bwd_kernel_head_groups(gen, T, H):
    """One head, and 10 heads that ``ssd_scan_bwd.plan`` cuts into groups of
    3, 3, 3 and 1 (T = 1024: partials summed by ``ssd_bwd_group_sum``):
    each gradient within 1e-4 of its largest entry against the plain
    decomposition and autograd through the plain scan."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan_bwd as bwd_mod
    if H == 10:
        assert bwd_mod.head_groups(bwd_mod.plan(2, T, H, 16, 128, 128), H) == [
            (0, 3), (3, 6), (6, 9), (9, 10)]
    xs = _ssd_inputs(gen, 2, T, H, 16, 128, torch.float32)
    s0 = torch.randn((2, H, 128, 16), generator=gen, device="cuda")
    dy = torch.randn((2, T, H, 16), generator=gen, device="cuda")
    d_final = torch.randn((2, H, 128, 16), generator=gen, device="cuda")
    got = _ssd_grads(xs, s0, dy, d_final, 128)
    two = ref.ssd_scan_bwd_two_pass(*xs, dy, chunk=128, initial_state=s0, d_final=d_final)
    for exp in (two, _ssd_grads(xs, s0, dy, d_final, 128, force="plain")):
        for g, e in zip(got, exp):
            assert torch.isfinite(g).all()
            assert float((g - e).abs().max()) <= SSD_BWD_TOL[torch.float32] * float(e.abs().max())


def test_ssd_bwd_kernel_at_the_smallest_shape(gen):
    """One chunk of 16 with one head, N = 4 and P = 16: the rows of the
    kernel's 128-row tiles past the chunk read nothing of C·Bᵀ, whose
    scratch holds only this chunk's 16 × 16 block."""
    from repro_torch.kernels import ref
    xs = _ssd_inputs(gen, 1, 16, 1, 16, 4, torch.float32)
    s0 = torch.randn((1, 1, 4, 16), generator=gen, device="cuda")
    dy = torch.randn((1, 16, 1, 16), generator=gen, device="cuda")
    d_final = torch.randn((1, 1, 4, 16), generator=gen, device="cuda")
    got = _ssd_grads(xs, s0, dy, d_final, 16)
    two = ref.ssd_scan_bwd_two_pass(*xs, dy, chunk=16, initial_state=s0, d_final=d_final)
    for exp in (two, _ssd_grads(xs, s0, dy, d_final, 16, force="plain")):
        for g, e in zip(got, exp):
            assert torch.isfinite(g).all()
            assert float((g - e).abs().max()) <= SSD_BWD_TOL[torch.float32] * float(e.abs().max())


def test_ssd_bwd_kernel_is_the_same_bits_every_run(gen):
    """No atomics: the heads' partials of dB and dC are summed in order."""
    xs = _ssd_inputs(gen, 2, 300, 8, 64, 128, torch.float32)
    s0 = torch.randn((2, 8, 128, 64), generator=gen, device="cuda")
    dy = torch.randn((2, 300, 8, 64), generator=gen, device="cuda")
    first = _ssd_grads(xs, s0, dy, None, 128)
    for _ in range(3):
        for a, b in zip(first, _ssd_grads(xs, s0, dy, None, 128)):
            assert torch.equal(a, b)


def test_ssd_bwd_kernel_takes_strided_views(gen):
    """B and C as slices of one projection, as the SSD layer hands them over."""
    proj = torch.randn((2, 40, 64 + 2 * 32), generator=gen, device="cuda")
    xdt, dA, _, _ = _ssd_inputs(gen, 2, 40, 4, 16, 32, torch.float32)
    dy = torch.randn((2, 40, 4, 16), generator=gen, device="cuda")

    def grads(force):
        p = proj.detach().requires_grad_()
        ins = [xdt.detach().requires_grad_(), dA.detach().requires_grad_()]
        y, _ = ops.ssd_scan(*ins, p[..., 64:96], p[..., 96:], chunk=32, force=force)
        return torch.autograd.grad(y, ins + [p], dy)
    for g, e in zip(grads(None), grads("plain")):
        assert float((g - e).abs().max()) <= 1e-4 * float(e.abs().max())


def test_mamba2_with_kernel_matches_plain(gen):
    """Reduced mamba2_370m in fp32: a prefill, a ragged prefill chunk from the
    carried state and a decode, with K3 against the plain scan (2e-3)."""
    cfg = get_reduced_config("mamba2_370m")
    model = build_model(cfg)
    params = model.init(gen, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 62), generator=gen, device="cuda")
    logits = {}
    for force in (None, "plain"):
        cache = model.init_cache(2, 64, torch.float32)
        ops.reset_launch_counts()
        a, cache = model.prefill(params, {"tokens": toks[:, :24]}, cache, force=force)
        b, cache = model.prefill(params, {"tokens": toks[:, 24:61]}, cache, force=force)
        c, cache = model.decode_step(params, cache, toks[:, 61:], force=force)
        assert ops.launch_counts()["ssd_scan"] == (0 if force else 2 * cfg.num_layers)
        logits[force] = (a, b, c, cache["layers"]["state"].clone())
    for got, exp in zip(logits[None], logits["plain"]):
        torch.testing.assert_close(got, exp, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,q_offset,window", [
    (1, 64, 64, 4, 2, 64, 64, None),         # the cache segment: no mask at all
    (2, 77, 129, 16, 2, 128, 129, 48),       # s0 off the KV tile grid, rows past the window
    (1, 96, 333, 10, 1, 256, 333, 64),       # recurrentgemma_2b's heads
    (1, 50, 70, 6, 1, 32, 70, 1),            # every row sees no key
    (1, 100, 100, 8, 2, 64, 0, 20),          # the new chunk's own segment
    (1, 40, 200, 8, 2, 64, 37, 30),          # an offset in between
    (1, 128, 256, 8, 2, 64, None, None)])    # the default offset, with the lse
def test_flash_kernel_segment_matches_plain(gen, B, T, S, Hq, Hkv, D, q_offset, window, dtype):
    """K1 with ``q_offset`` and ``return_lse``, the deferred append's
    segments, against the plain version: out and lse, -inf in the same rows."""
    q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    kw = dict(q_offset=q_offset, window=window, return_lse=True)
    out, lse = ops.flash_attention(q, k, v, **kw)
    exp, exp_lse = ops.flash_attention(q, k, v, force="plain", **kw)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)
    assert torch.equal(torch.isinf(lse), torch.isinf(exp_lse))
    seen = ~torch.isinf(exp_lse)
    torch.testing.assert_close(lse[seen], exp_lse[seen], rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 1, 16, 129])
def test_paged_kernel_lse_matches_plain(gen, dtype, window):
    """K2 with ``return_lse`` over contexts that include an empty one (0 and
    -inf there), with the deferred decode's window less one."""
    B, Hq, Hkv, D, page, pps = 6, 8, 2, 64, 16, 24
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(dtype)
    tables = torch.randperm(B * pps, generator=gen, device="cuda").int().view(B, pps)
    ctx = torch.tensor([0, 1, 63, 65, 133, 384], dtype=torch.int32, device="cuda")
    out, lse = ops.paged_attention(q, kp, vp, tables, ctx, window=window, return_lse=True)
    exp, exp_lse = ops.paged_attention(q, kp, vp, tables, ctx, window=window,
                                       return_lse=True, force="plain")
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert (out[0] == 0).all() and torch.isinf(lse[0]).all()
    torch.testing.assert_close(out[1:].float(), exp[1:].float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse[1:], exp_lse[1:], rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "recurrentgemma_2b"])
def test_defer_model_with_kernels_matches_plain(gen, arch):
    """Reduced models (head_dim 32, which the kernels take) with
    ``kv_append="defer"`` in fp32: two prefill chunks and two decodes with
    K1 and K2 against the plain attention (2e-3), K1 twice a layer on the
    second chunk."""
    cfg = get_reduced_config(arch).replace(kv_append="defer", head_dim=32, d_model=128)
    model = build_model(cfg)
    params = model.init(gen, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, device="cuda")
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_pattern)
    logits = {}
    for force in (None, "plain"):
        cache = model.init_cache(2, 64, torch.float32)
        ops.reset_launch_counts()
        out = [model.prefill(params, {"tokens": toks[:, :16]}, cache, force=force)[0],
               model.prefill(params, {"tokens": toks[:, 16:38]}, cache, force=force)[0]]
        out += [model.decode_step(params, cache, toks[:, t:t + 1], force=force)[0]
                for t in (38, 39)]
        if force is None:
            assert ops.launch_counts()["flash_attention"] == 3 * n_attn
            assert ops.launch_counts()["paged_attention"] == 2 * n_attn
        logits[force] = out
    for got, exp in zip(logits[None], logits["plain"]):
        torch.testing.assert_close(got, exp, rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------------------
# training: K1's gradient kernel and train steps with the kernels
# --------------------------------------------------------------------------

# K1-bwd against autograd through the plain version on the same values in
# fp32, as a share of the largest entry of dq, dk, dv: fp32 1e-3 (sums over
# up to hundreds of keys and a group's heads in another order, and dS
# subtracts two of them), bf16 2e-2 (K1's bf16 output enters delta, and the
# gradients are rounded to bf16).
BWD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


def _grads(q, k, v, dout, force=None, **kw):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(q, k, v, force=force, **kw)
    return torch.autograd.grad(out, (q, k, v), dout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,kw", [
    (4, 512, 512, 16, 2, 128, {}),                  # qwen2_5_3b's training shape
    (1, 37, 37, 8, 1, 32, {}), (2, 100, 100, 10, 1, 256, {"window": 33}),
    (1, 1, 1, 2, 2, 64, {}), (1, 70, 70, 4, 2, 64, {"window": 1}),
    (2, 448, 1500, 8, 8, 64, {"causal": False}),    # whisper's cross-attention
    (1, 64, 200, 4, 4, 32, {"q_offset": 200, "window": 40})])   # rows that see no key
def test_flash_bwd_kernel_matches_plain(gen, B, T, S, Hq, Hkv, D, kw, dtype):
    q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    dout = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dtype)
    ops.reset_launch_counts()
    got = _grads(q, k, v, dout, **kw)
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    exp = _grads(q.float(), k.float(), v.float(), dout.float(), force="plain", **kw)
    largest = max(float(e.abs().max()) for e in exp)
    for g, e in zip(got, exp):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert float((g.float() - e).abs().max()) <= BWD_TOL[dtype] * largest


# K1's fp32 kernel (3xTF32 mma.sync) at the edges of its tiles: T and S off
# 16 and off the key tiles (64, 32 at D = 128, 16 at D = 256), S = 1, G of
# 1, 8 and 10, D = 256, whisper's 448 x 1500 cross shape, rows that see no
# key; output and lse against the plain version at 2e-4.
F32_EDGES = [
    (1, 1, 1, 2, 2, 64, {}), (1, 1, 1, 8, 1, 32, {"causal": False}),
    (2, 37, 53, 16, 2, 128, {}), (1, 65, 65, 10, 1, 256, {}),
    (1, 100, 333, 10, 1, 256, {"window": 70}), (2, 448, 1500, 8, 8, 64, {"causal": False}),
    (1, 17, 200, 8, 1, 32, {"window": 5}), (3, 129, 130, 8, 8, 128, {}),
    (1, 50, 70, 10, 1, 256, {"q_offset": 70, "window": 20})]


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,kw", F32_EDGES)
def test_flash_f32_kernel_at_tile_edges(gen, B, T, S, Hq, Hkv, D, kw):
    q = torch.randn((B, T, Hq, D), generator=gen, device="cuda")
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda")
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda")
    ops.reset_launch_counts()
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    assert ops.launch_counts()["flash_attention"] == 1
    exp, exp_lse = ops.flash_attention(q, k, v, return_lse=True, force="plain", **kw)
    torch.testing.assert_close(out, exp, rtol=2e-4, atol=2e-4)
    assert torch.equal(torch.isinf(lse), torch.isinf(exp_lse))
    seen = ~torch.isinf(exp_lse)
    torch.testing.assert_close(lse[seen], exp_lse[seen], rtol=2e-4, atol=2e-4)


# K1-bwd at the edges of its tiles: T and S off 16 and off the key tiles,
# S = 1, G of 1, 8 and 10 (partials summed when G > 1), D = 256 (two warps
# a key group), whisper's 448 x 1500 cross shape, rows that see no key.
BWD_EDGES = [
    (1, 1, 1, 8, 1, 64, {}), (1, 17, 17, 10, 1, 128, {}),
    (2, 45, 61, 8, 1, 32, {"causal": False}), (1, 70, 70, 10, 1, 256, {}),
    (1, 33, 97, 8, 8, 64, {"window": 20}), (1, 130, 130, 16, 2, 128, {"window": 77}),
    (2, 448, 1500, 8, 8, 64, {"causal": False}),
    (1, 100, 300, 16, 2, 256, {"q_offset": 250, "window": 64})]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,kw", BWD_EDGES)
def test_flash_bwd_kernel_at_tile_edges(gen, B, T, S, Hq, Hkv, D, kw, dtype):
    test_flash_bwd_kernel_matches_plain(gen, B, T, S, Hq, Hkv, D, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_is_the_same_bits_every_run(gen, dtype):
    """No atomics: the G partials are summed in a fixed order, so two runs
    on the same inputs give the same bits."""
    q = torch.randn((2, 200, 16, 128), generator=gen, device="cuda").to(dtype)
    k = torch.randn((2, 200, 2, 128), generator=gen, device="cuda").to(dtype)
    v = torch.randn((2, 200, 2, 128), generator=gen, device="cuda").to(dtype)
    dout = torch.randn((2, 200, 16, 128), generator=gen, device="cuda").to(dtype)
    first = _grads(q, k, v, dout)
    for _ in range(3):
        for a, b in zip(first, _grads(q, k, v, dout)):
            assert torch.equal(a, b)


def test_moe_is_the_same_bits_every_run(gen):
    """ROADMAP C1: the dropless MoE in bf16 on the card (grouped products,
    each token's outputs summed over a fixed axis, no atomic adds) gives the
    same bits on the same inputs in every call."""
    from repro_torch.models import layers as L
    cfg = get_reduced_config("qwen3_30b_a3b")
    p = L.moe_params(cfg, gen, torch.bfloat16, "cuda")
    x = torch.randn((4, 128, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    first = L.moe(cfg, p, x)[0]
    for _ in range(4):
        assert torch.equal(L.moe(cfg, p, x)[0], first)


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")


def _train_counts(cfg, microbatches):
    """Launches of K1, K1-bwd, K3 and K3-bwd (a gradient kernel: one per
    call) in one remat train step: each block's forward runs twice."""
    if cfg.encoder is not None:            # encoder without remat; self and cross with it
        enc, dec = cfg.encoder.num_layers, cfg.num_layers
        return (enc + 4 * dec) * microbatches, (enc + 2 * dec) * microbatches, 0, 0
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_pattern)
    n_ssd = sum(kind == "ssd" for kind in cfg.layer_pattern)
    return (2 * n_attn * microbatches, n_attn * microbatches, 2 * n_ssd * microbatches,
            n_ssd * microbatches)


@pytest.mark.parametrize("arch", ["llama3_8b", "qwen3_30b_a3b", "mixtral_8x7b",
                                  "recurrentgemma_2b", "whisper_base", "mamba2_370m"])
def test_train_step_with_kernels_matches_plain(gen, arch):
    """Reduced dense, MoE, windowed (mixtral, window 64 over 96 tokens),
    RecurrentGemma, Whisper and Mamba2 models at head_dim 32 (K1 rejects the
    reduced configs' 16) in fp32: the loss and every gradient of a remat
    step of two microbatches through K1 and K1-bwd, and K3 and K3-bwd,
    against the plain attention and scan (loss 1e-4; each leaf within 1e-3
    of its largest plain entry)."""
    from repro_torch.models.optim import tree_leaves, value_and_grad
    cfg = get_reduced_config(arch).replace(head_dim=32, d_model=128)
    model = build_model(cfg)
    params = model.init(gen, torch.float32)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 96), generator=gen, device="cuda"),
             "labels": torch.randint(0, cfg.vocab_size, (4, 96), generator=gen, device="cuda")}
    if cfg.encoder is not None:
        batch["frontend_embeds"] = torch.randn((4, 150, cfg.d_model), generator=gen,
                                               device="cuda")
    res = {}
    for force in (None, "plain"):
        ops.reset_launch_counts()
        loss, _, grads = value_and_grad(model, params, batch, microbatches=2, force=force)
        counts = ops.launch_counts()
        res[force] = (float(loss), [g.clone() for g in tree_leaves(grads)],
                      tuple(counts[k] for k in TRAIN_KERNELS))
    assert res[None][2] == _train_counts(cfg, 2)
    assert res["plain"][2] == (0, 0, 0, 0)
    assert res[None][0] == pytest.approx(res["plain"][0], rel=1e-4)
    for g, e in zip(res[None][1], res["plain"][1]):
        assert torch.isfinite(g).all()
        assert float((g - e).abs().max()) <= 1e-3 * max(float(e.abs().max()), 1e-6)


def test_ssd_training_runs_through_k3_and_k3_bwd(gen):
    """The reduced mamba2_370m trains on the card: a remat train step of two
    microbatches at a ragged length (40 tokens, chunks of 16: the last
    ragged) launches K3 twice a layer a microbatch and K3-bwd once, every
    loss finite and the parameters moved, the plain scan none."""
    from repro_torch.models.optim import OptimizerConfig, init_adamw, make_train_step
    cfg = get_reduced_config("mamba2_370m")
    model = build_model(cfg)
    params = model.init(gen, torch.float32)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 40), generator=gen, device="cuda"),
             "labels": torch.randint(0, cfg.vocab_size, (4, 40), generator=gen, device="cuda")}
    step = make_train_step(model, OptimizerConfig(warmup_steps=1, total_steps=4), microbatches=2)
    opt = init_adamw(params)
    before = params["blocks"]["ssd"]["w_in"].detach().clone()
    ops.reset_launch_counts()
    for _ in range(2):
        params, opt, metrics = step(params, opt, batch)
        assert torch.isfinite(torch.as_tensor(metrics["loss"]))
    counts = ops.launch_counts()
    n = cfg.num_layers
    assert (counts["ssd_scan"], counts["ssd_scan_bwd"]) == (2 * 2 * 2 * n, 2 * 2 * n)
    assert float((params["blocks"]["ssd"]["w_in"].detach() - before).abs().max()) > 0
    ops.reset_launch_counts()
    loss, _ = model.train_loss(params, batch, force="plain")
    loss.backward()
    assert torch.isfinite(loss) and not any(ops.launch_counts().values())


def test_expert_parallel_moe_two_ranks_on_the_card(gen):     # gen: skips without a card
    """Two gloo ranks sharing the card (``repro_torch.launch.parallel``)
    at qwen3_30b_a3b's full width cut to one layer, 2 prompts of 128 tokens
    in bf16: the prefill through the all-to-all with K1 and the decode
    through the fallback with K2, the attention on each rank's 16 heads,
    against the dropless model on the same weights (relative 5e-2, as
    ``chip_smoke.py``'s model checks), nothing dropped at the no-drop
    capacity, each rank's blocks as its placements say (``parallel.check``)."""
    from repro_torch.launch import parallel as ep
    args = ep.parse_args(["--arch", "qwen3_30b_a3b", "--layers", "1", "--batch", "2",
                          "--prompt", "128"])
    launches = ep.check(args, ep.launch(args), ep.reference(args), 5e-2)
    assert launches["flash_attention"] == 2 * args.ranks and launches["paged_attention"] == args.ranks


def test_training_on_a_two_by_two_mesh_on_the_card(gen):     # gen: skips without a card
    """``launch.train --mesh 2,2``: 4 gloo ranks sharing the card, reduced
    llama3_8b at head_dim 32 (as the tests above) and mamba2_370m, one step
    of two microbatches in fp32 against the one-process step on the same
    weights and batch (``train.check``: each rank's blocks and their
    allocated bytes, the loss 1e-4, grad_norm 1e-3, step 1's gradients 1e-3
    of each leaf's largest entry), K1 and K1-bwd, or K3 and K3-bwd, on every
    rank (``train.kernel_launches``)."""
    from repro_torch.launch import train
    for argv in (["--arch", "llama3_8b", "--config", "head_dim=32", "--config", "d_model=128"],
                 ["--arch", "mamba2_370m"]):
        args = train.parse_args(argv + ["--mesh", "2,2", "--steps", "1", "--batch", "8",
                                        "--seq", "64"])
        ranks, ref = train.launch(args), train.reference(args)
        launches = train.check(args, ranks, ref, train.gradient_errors(args, ranks, ref),
                               loss_tol=1e-4, norm_tol=1e-3, leaf_tol=1e-3)
        expect = {k: 4 * n for k, n in train.kernel_launches(args).items() if n}
        assert {k: launches[k] for k in expect} == expect


def test_serving_on_a_two_by_two_mesh_on_the_card(gen):     # gen: skips without a card
    """``launch.parallel --mesh 2,2``: 4 gloo ranks sharing the card in
    fp32, reduced mixtral_8x7b at head_dim 32 (K2 takes 32 and up) at
    batch 1 past its 64-slot ring (K2 on each "data" rank's block of it,
    merged over "data"; the experts' d over "data") and reduced
    qwen3_30b_a3b with its rows over "data", against the one-process model
    on the same weights (``parallel.check`` at 2e-4: each rank's blocks and
    their allocated bytes, its K1 and K2 launches by
    ``parallel.kernel_launches``)."""
    from repro_torch.launch import parallel
    for argv in (["--arch", "mixtral_8x7b", "--batch", "1", "--prompt", "80"],
                 ["--arch", "qwen3_30b_a3b", "--batch", "4", "--prompt", "24"]):
        args = parallel.parse_args(argv + ["--reduced", "--config", "head_dim=32", "--mesh",
                                           "2,2", "--dtype", "float32", "--decodes", "3"])
        launches = parallel.check(args, parallel.launch(args), parallel.reference(args), 2e-4)
        assert launches["flash_attention"] == 4 * 2 and launches["paged_attention"] > 0
