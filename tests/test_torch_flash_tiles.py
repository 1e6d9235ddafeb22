"""K1's bf16 kernel, decomposed in plain PyTorch, on the CPU.

* ``ref.flash_attention_tiled`` spells out the kernel's arithmetic: GQA-
  packed (position, head) rows, the walk over the KV tiles a query tile can
  see, masks only where an edge crosses a tile, the log2-domain online
  softmax with P rounded to the input type before P @ V.  It is held against
  the JAX package's ``flash_attention_ref`` and its Pallas kernel in
  interpret mode on the shapes of ``tests/test_kernels.py``, plus G = 8 at
  D = 128 and bf16 windows with G > 1, over every tile choice of the kernel.
* The edge predicate (``flash_attention.tile_needs_mask``) never skips the
  mask on a tile that the full mask cuts, over a sweep of T, S - T, window,
  G and tile sizes; the tile range (``kv_tile_range``) leaves out no key a
  row can see.
* ``flash_attention.plan``: every (query tile, packed head group, KV head,
  batch) is covered once, the heaviest query tiles come first, and shared
  memory stays within a block's 227 KB for every D and tile choice.
* The wrapper refuses batch strides that TMA cannot take, and reads no
  device value.

Tolerances are the reference's (``tests/test_kernels.py``): 2e-4 in fp32,
2e-2 in bf16.  Inputs are made with numpy from a seed and handed to both
packages.
"""

import ast
import functools
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)    # the suite runs in several workers at once

KERNELS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "kernels"
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
TILES = flash_mod.TILES

# (B, T, S, Hq, Hkv, D), dtype, kwargs: the cases of tests/test_torch_kernels.py
# (those of tests/test_kernels.py), then G = 8 at D = 128 (qwen2_5_3b's widths)
# and bf16 windows with G > 1, which the kernel's packing changes
CASES = (
    [(shape, dt, {}) for shape in [
        (1, 128, 128, 4, 4, 64), (2, 128, 256, 8, 2, 64), (1, 64, 64, 4, 1, 128),
        (1, 100, 100, 2, 2, 64), (1, 32, 160, 4, 4, 32),
    ] for dt in ("float32", "bfloat16")]
    + [((1, 128, 128, 4, 2, 64), "float32", {"window": w}) for w in (16, 64, 4096)]
    + [((2, 64, 64, 4, 4, 64), "float32", {"causal": False}),
       ((1, 64, 64, 2, 2, 64), "float32", {"softmax_scale": 0.5})]
    + [((1, T, T + extra, Hkv * G, Hkv, D), "float32", {})
       for T, extra, Hkv, G, D in [(8, 0, 1, 1, 32), (33, 16, 2, 2, 64),
                                   (64, 93, 1, 4, 32), (127, 0, 2, 4, 64),
                                   (127, 93, 2, 1, 32), (33, 93, 1, 2, 64)]]
    + [((1, 100, 228, 16, 2, 128), dt, {}) for dt in ("float32", "bfloat16")]
    + [((1, 130, 200, 8, 2, 64), "bfloat16", {"window": w}) for w in (16, 100)]
)
IDS = [f"{s}-{d}-{k}" for s, d, k in CASES]


def _inputs(shape, dtype):
    B, T, S, Hq, Hkv, D = shape
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    jax_in = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    torch_in = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jax_in, torch_in


@functools.lru_cache(maxsize=None)
def _jax_outputs(case: int):
    """The JAX reference and the Pallas kernel (interpret mode) on one case,
    computed once for all tile choices."""
    shape, dtype, kw = CASES[case]
    (jq, jk, jv), _ = _inputs(shape, dtype)
    return (np.asarray(jref.flash_attention_ref(jq, jk, jv, **kw), np.float32),
            np.asarray(pallas_flash(jq, jk, jv, interpret=True, **kw), np.float32))


@pytest.mark.parametrize("block_rows,block_keys", TILES)
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_flash_tiled_matches_jax(case, block_rows, block_keys):
    shape, dtype, kw = CASES[case]
    _, (tq, tk, tv) = _inputs(shape, dtype)
    out = tref.flash_attention_tiled(tq, tk, tv, block_rows=block_rows,
                                     block_keys=block_keys, **kw)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    for exp in _jax_outputs(case):
        np.testing.assert_allclose(out.float().numpy(), exp, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("block_rows,block_keys", TILES)
def test_flash_tiled_matches_plain_on_ragged_gqa(block_rows, block_keys):
    """Packings that do not fill a tile (G = 3 and 6), ragged T and S, and a
    batch of three, against the port's plain version."""
    rng = np.random.default_rng(block_rows + block_keys)
    for (B, T, S, Hq, Hkv, D), kw in [((3, 45, 301, 6, 2, 32), {}),
                                      ((1, 77, 77, 3, 1, 64), {"window": 30}),
                                      ((2, 129, 140, 12, 2, 32), {})]:
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
        torch.testing.assert_close(
            tref.flash_attention_tiled(q, k, v, block_rows=block_rows,
                                       block_keys=block_keys, **kw),
            tref.flash_attention_ref(q, k, v, **kw), rtol=2e-4, atol=2e-4)


# =========================================================================
# the edge predicate and the tile range
# =========================================================================

def _full_mask(T, S, causal, window):
    """(T, S) visibility of the plain version."""
    qpos = np.arange(T)[:, None] + (S - T)
    key = np.arange(S)[None, :]
    ok = np.ones((T, S), bool)
    if causal:
        ok &= key <= qpos
        if window is not None:
            ok &= qpos - key < window
    return ok


@pytest.mark.parametrize("block_rows,block_keys", TILES)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 1), (True, 40),
                                           (True, 200), (False, None)])
def test_edge_predicate_never_skips_a_cut_tile(block_rows, block_keys, causal, window):
    """Over T, S - T and G: a KV tile in a query tile's range that the
    predicate leaves unmasked is visible in full to every row of the query
    tile, and no visible key lies outside the range.  Unless the window is
    shorter than a tile, some tiles do skip the mask, or the predicate would
    buy nothing."""
    skipped = 0
    for T, extra, G in itertools.product((1, 7, 64, 100, 257), (0, 5, 128, 300), (1, 4, 8)):
        S = T + extra
        p = flash_mod.plan(1, T, S, G, 1, 64, block_rows=block_rows, block_keys=block_keys)
        assert p.pack == flash_mod.pack_factor(G, block_rows)
        vis = _full_mask(T, S, causal, window)
        bk = block_keys
        for qt in range(p.q_tiles):
            q0 = qt * p.positions
            rows = vis[q0:min(q0 + p.positions, T)]
            first, end = flash_mod.kv_tile_range(q0, p.positions, T, S, bk, causal, window)
            seen = np.zeros(S, bool)
            seen[first * bk:end * bk] = True
            assert not (rows & ~seen[None, :]).any(), (T, S, G, qt)
            assert first < end
            for kt in range(first, end):
                k0 = kt * bk
                if not flash_mod.tile_needs_mask(k0, bk, S, q0 + S - T,
                                                 q0 + len(rows) - 1 + S - T, causal, window):
                    skipped += 1
                    assert k0 + bk <= S and rows[:, k0:k0 + bk].all(), (T, S, G, qt, kt)
    assert skipped > 0 or window <= block_keys


def test_timed_shape_masks_only_the_edge_tiles():
    """At the llama3_8b prefill shape (T=512 after 512 cached tokens) each
    query tile of 32 positions masks only the KV tile on its diagonal."""
    p = flash_mod.plan(1, 512, 1024, 32, 8, 128)
    assert (p.pack, p.positions, p.q_tiles, p.blocks) == (4, 32, 16, 128)
    for qt in range(p.q_tiles):
        q0 = qt * p.positions
        first, end = flash_mod.kv_tile_range(q0, p.positions, 512, 1024, p.block_keys, True, None)
        masked = [kt for kt in range(first, end)
                  if flash_mod.tile_needs_mask(kt * p.block_keys, p.block_keys, 1024, q0 + 512,
                                               q0 + 543, True, None)]
        assert masked == [end - 1]


# =========================================================================
# the plan
# =========================================================================

@pytest.mark.parametrize("G,rows,pack", [(1, 128, 1), (2, 64, 2), (3, 128, 1), (4, 128, 4),
                                         (6, 64, 2), (8, 128, 8), (8, 64, 8), (16, 64, 16),
                                         (32, 64, 32), (128, 64, 64)])
def test_pack_factor(G, rows, pack):
    assert flash_mod.pack_factor(G, rows) == pack


@pytest.mark.parametrize("block_rows,block_keys", TILES)
@pytest.mark.parametrize("B,T,S,Hq,Hkv", [(1, 512, 1024, 32, 8), (2, 100, 300, 16, 2),
                                          (3, 1, 9, 6, 2), (1, 379, 379, 8, 8)])
def test_plan_covers_every_tile_once_heaviest_first(B, T, S, Hq, Hkv, block_rows, block_keys):
    p = flash_mod.plan(B, T, S, Hq, Hkv, 128, block_rows=block_rows, block_keys=block_keys)
    assert p.positions * p.pack == p.block_rows and p.groups * p.pack == Hq // Hkv
    assert p.q_tiles * p.positions >= T > (p.q_tiles - 1) * p.positions
    coords = [flash_mod.block_coords(p, B, Hkv, i) for i in range(p.blocks)]
    assert sorted(coords) == sorted(itertools.product(range(B), range(Hkv), range(p.groups),
                                                      range(p.q_tiles)))
    work = []
    for _, _, _, qt in coords:
        first, end = flash_mod.kv_tile_range(qt * p.positions, p.positions, T, S,
                                             block_keys, True, None)
        work.append(end - first)
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("block_rows,block_keys", TILES)
@pytest.mark.parametrize("D", flash_mod.HEAD_DIMS)
def test_plan_fits_shared_memory(D, block_rows, block_keys):
    """Every tile the kernel builds fits a block's shared memory; the one
    that would not (64 x 128 at D = 256) is refused, not launched."""
    if flash_mod.smem_bytes(D, block_rows, block_keys) > flash_mod.SMEM_LIMIT:
        assert (D, block_rows, block_keys) == (256, 64, 128)
        with pytest.raises(ValueError, match="shared memory"):
            flash_mod.plan(1, 512, 1024, 32, 8, D, block_rows=block_rows,
                           block_keys=block_keys)
        return
    p = flash_mod.plan(1, 512, 1024, 32, 8, D, block_rows=block_rows, block_keys=block_keys)
    assert p.smem_bytes == flash_mod.smem_bytes(D, block_rows, block_keys)
    assert p.smem_bytes <= flash_mod.SMEM_LIMIT
    assert p.threads == 128 * (block_rows // 64 + 1)


def test_plan_agrees_with_the_source():
    """The wrapper's constants are the kernel's: two stages, 64 rows a
    consumer warpgroup, the same shared-memory sum."""
    source = (KERNELS / "csrc" / "flash_attention.cu").read_text()
    assert f"static constexpr int kStages = {flash_mod.STAGES};" in source
    assert "static constexpr int kRows = 64 * NWG;" in source
    assert ("kSmemBytes = 1024 + kQBytes + 2 * kStages * kKVBytes + kBarrierBytes;"
            in source)
    for rows, keys in flash_mod.TILES:
        assert f"if (block_rows == {rows} && block_keys == {keys})" in source


@pytest.mark.parametrize("B,T,S,Hq,Hkv,tiles", [
    (1, 512, 1024, 32, 8, (128, 64)),     # the timed shape: 128 blocks of 128 rows
    (1, 512, 1024, 16, 2, (64, 128)),     # G = 8: 64 blocks of 128 rows would idle half the SMs
    (1, 379, 891, 32, 8, (128, 64)),      # 96 blocks: two thirds of the SMs and more
    (1, 195, 195, 32, 8, (64, 64)),       # 56 blocks of 128 rows: too few
    (1, 11, 11, 32, 8, (64, 64)),
    (1, 55, 699, 32, 8, (64, 128)),       # 64-row tiles over 512 keys and more
    (4, 64, 2048, 32, 8, (64, 128))])    # 64 blocks of 128 rows; 2048 keys
def test_plan_default_tiles(B, T, S, Hq, Hkv, tiles):
    p = flash_mod.plan(B, T, S, Hq, Hkv, 128)
    assert (p.block_rows, p.block_keys) == tiles


def test_plan_refuses_unknown_tiles():
    with pytest.raises(ValueError, match="tiles"):
        flash_mod.plan(1, 64, 64, 4, 1, 64, block_rows=96)
    with pytest.raises(ValueError, match="tiles"):
        flash_mod.plan(1, 64, 64, 4, 1, 64, block_keys=32)
    with pytest.raises(ValueError, match="tiles"):
        flash_mod.plan(1, 64, 64, 4, 1, 64, block_rows=128, block_keys=128)


# =========================================================================
# the wrapper
# =========================================================================

def test_tma_batch_stride():
    """A slot-cache view keeps its stride; a batch of one gets the dense
    stride whatever its own; a stride that is not a multiple of 16 bytes is
    refused."""
    cache = torch.zeros(4, 2048, 8, 128, dtype=torch.bfloat16)
    assert flash_mod.tma_batch_stride("k", cache[:, :300]) == 2048 * 8 * 128
    assert flash_mod.tma_batch_stride("k", cache[1:2, :300]) == 300 * 8 * 128
    odd = torch.zeros(2, 8 * 4 * 32 + 4, dtype=torch.bfloat16)[:, :8 * 4 * 32].view(2, 8, 4, 32)
    with pytest.raises(ValueError, match="batch stride of q"):
        flash_mod.tma_batch_stride("q", odd)
    assert flash_mod.tma_batch_stride("q", odd[:1]) == 8 * 4 * 32
    padded = torch.zeros(2, 8 * 4 * 32 + 8, dtype=torch.bfloat16)[:, :8 * 4 * 32].view(2, 8, 4, 32)
    assert flash_mod.tma_batch_stride("q", padded) == 8 * 4 * 32 + 8


def test_wrapper_reads_no_device_value():
    """The wrapper plans from shapes alone, so that a prefill can be
    captured in a CUDA graph: no .item(), .tolist(), .cpu() or .numpy()."""
    tree = ast.parse((KERNELS / "flash_attention.py").read_text())
    reads = [node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)
             and node.attr in ("item", "tolist", "cpu", "numpy")]
    assert reads == []


def test_wrapper_has_no_fallback():
    """No try around the launch: a bf16 CUDA tensor launches the bf16 kernel
    or raises."""
    tree = ast.parse((KERNELS / "flash_attention.py").read_text())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))
