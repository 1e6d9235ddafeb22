"""K1 and K2 at RecurrentGemma's attention shapes (head_dim 256, 10 query
heads over one KV head: G * D = 2560) and K1 non-causal with S off its KV
tile grid (Whisper's encoder and cross-attention), on the CPU.

* ``flash_attention.plan`` at D = 256 stays within a block's shared memory
  (``SMEM_LIMIT``), never picks the 64 x 128 tile that would not fit it and
  refuses it when asked, and packs G = 10 by 2 into 5 groups.
* ``ref.flash_attention_tiled`` (K1's bf16 kernel spelled out in plain
  PyTorch) at D = 256, G = 10, with and without a window, over every tile
  the kernel builds at that head dim, and non-causal at D = 64 with S not a
  multiple of the KV tile: against the JAX package's reference and its
  Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it.
* ``ref.paged_attention_ref`` and ``ref.paged_attention_split`` (K2's split
  and merge) at D = 256, G = 10, with a window for the plain versions,
  against the Pallas kernel in interpret mode.

Tolerances are the reference's: 2e-4 in fp32, 2e-2 in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import paged_attention as paged_mod
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)    # the suite runs in several workers at once

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
TILES_256 = [t for t in flash_mod.TILES
             if flash_mod.smem_bytes(256, *t) <= flash_mod.SMEM_LIMIT]


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("T,S", [(3072, 3072), (512, 3072), (1, 3072), (64, 100), (2048, 2048)])
def test_plan_at_head_dim_256(T, S):
    p = flash_mod.plan(1, T, S, 10, 1, 256)
    assert p.smem_bytes <= flash_mod.SMEM_LIMIT
    assert (p.block_rows, p.block_keys) in TILES_256
    assert p.pack == 2 and p.groups == 5 and p.positions == p.block_rows // 2
    assert p.blocks == p.q_tiles * 5


def test_plan_refuses_tiles_past_the_shared_memory():
    assert TILES_256 == [(64, 64), (128, 64)]
    assert flash_mod.smem_bytes(256, 64, 128) > flash_mod.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        flash_mod.plan(1, 100, 600, 10, 1, 256, block_rows=64, block_keys=128)
    for D in flash_mod.HEAD_DIMS:
        for T, S, Hq, Hkv in [(512, 1024, 32, 8), (3072, 3072, 10, 1), (64, 600, 8, 8)]:
            assert flash_mod.plan(1, T, S, Hq, Hkv, D).smem_bytes <= flash_mod.SMEM_LIMIT


# (B, T, S, Hq, Hkv, D), dtype, kwargs
FLASH_CASES = (
    [((1, 40, 100, 10, 1, 256), dt, kw) for dt in ("float32", "bfloat16")
     for kw in ({}, {"window": 24})]
    + [((2, 33, 33, 10, 1, 256), "bfloat16", {}),
       ((1, 50, 150, 8, 8, 64), "bfloat16", {"causal": False}),
       ((1, 7, 150, 8, 8, 64), "float32", {"causal": False}),
       ((1, 20, 75, 10, 1, 256), "bfloat16", {"causal": False})])


@pytest.mark.parametrize("case", range(len(FLASH_CASES)),
                         ids=[f"{s}-{d}-{k}" for s, d, k in FLASH_CASES])
def test_flash_tiled_matches_jax(case):
    (B, T, S, Hq, Hkv, D), dtype, kw = FLASH_CASES[case]
    arrs = _arrays(((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)), case)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    expected = [np.asarray(jref.flash_attention_ref(jq, jk, jv, **kw), np.float32),
                np.asarray(pallas_flash(jq, jk, jv, interpret=True, **kw), np.float32)]
    tiles = TILES_256 if D == 256 else flash_mod.TILES
    for block_rows, block_keys in tiles:
        out = tref.flash_attention_tiled(tq, tk, tv, block_rows=block_rows,
                                         block_keys=block_keys, **kw)
        assert out.shape == tq.shape and out.dtype == tq.dtype
        for exp in expected:
            np.testing.assert_allclose(out.float().numpy(), exp, rtol=TOL[dtype],
                                       atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_at_head_dim_256_matches_pallas(dtype):
    B, Hq, Hkv, D, page, pps = 4, 10, 1, 256, 16, 6
    num_pages = B * pps + 2
    q, kp, vp = _arrays(((B, Hq, D), (num_pages, page, Hkv, D), (num_pages, page, Hkv, D)), 7)
    rng = np.random.default_rng(7)
    tables = rng.permutation(num_pages)[:B * pps].astype(np.int32).reshape(B, pps)
    ctx = np.array([1, 63, 65, pps * page], np.int32)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, kp, vp))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, kp, vp))
    tt, tc = torch.from_numpy(tables), torch.from_numpy(ctx)
    pallas = np.asarray(pallas_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(ctx),
                                     interpret=True), np.float32)
    assert Hq // Hkv * D <= paged_mod.MAX_GROUP_ELEMS
    for out in (tref.paged_attention_ref(tq, tk, tv, tt, tc),
                tref.paged_attention_split(tq, tk, tv, tt, tc)):
        assert out.shape == tq.shape and out.dtype == tq.dtype
        np.testing.assert_allclose(out.float().numpy(), pallas, rtol=TOL[dtype],
                                   atol=TOL[dtype])
    # with RecurrentGemma's kind of window, the split against the plain version
    for window in (1, 40, 64):
        torch.testing.assert_close(
            tref.paged_attention_split(tq, tk, tv, tt, tc, window=window).float(),
            tref.paged_attention_ref(tq, tk, tv, tt, tc, window=window).float(),
            rtol=TOL[dtype], atol=TOL[dtype])
