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
