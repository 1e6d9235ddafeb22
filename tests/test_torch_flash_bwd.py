"""K1's gradient kernel, in the parts that run on the CPU.

``ref.flash_attention_bwd_tiled`` spells out ``csrc/flash_attention_bwd.cu``
in plain PyTorch: its tiles, the query tiles each key tile walks
(``flash_attention.q_tile_range``), the key tiles each query tile walks
(``kv_tile_range``), delta, P recomputed from K1's log-sum-exp, dS, and the
G query heads' partials of a KV head summed in order.  It is held against
autograd through the plain version, ``ref.flash_attention_ref``, at 1e-5 in
fp32 over causal, non-causal (T != S), windowed, offset masks, G in
{1, 2, 8, 10}, D in {32, 64, 128, 256} and ragged T; the inverse tile range
against brute force; the plan (every block once, heaviest first, within
the shared memory, agreeing with the source); and the wrapper's checks and
dispatch.  ``tests/test_torch_tf32x3.py`` holds its products as 3xTF32.  The kernel itself runs on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3e).
"""

import ast
import itertools
import math
import operator
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import flash_attention_bwd as bwd_mod
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)    # the suite runs in several workers at once

KERNELS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "kernels"
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, T, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    dout = torch.from_numpy(rng.standard_normal((B, T, Hq, D)).astype(np.float32))
    return q, k, v, dout


def _autograd(q, k, v, dout, **kw):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    return out.detach(), lse.detach(), torch.autograd.grad(out, (q, k, v), dout)


# (causal, window, S - T or None for S = T, q_offset): causal, non-causal with
# T != S, a window, and the deferred append's cache segment (rows that see
# no key past the window)
MASKS = {"causal": (True, None, 0, None), "noncausal": (False, None, 23, None),
         "window": (True, 13, 5, None), "segment": (True, 40, 0, 64)}
# every head dim and every group size meets every mask once
CASES = [(D, G, list(MASKS)[(i + i // 4) % 4], (1, 37, 100)[i % 3]) for i, (D, G) in
         enumerate(itertools.product((32, 64, 128, 256), (1, 2, 8, 10)))]


@pytest.mark.parametrize("D,G,mask,T", CASES)
def test_tiled_backward_matches_autograd(D, G, mask, T):
    causal, window, extra, q_offset = MASKS[mask]
    Hkv = 1 if G == 10 else 2
    B, S = 2 if D < 256 else 1, T + extra
    q, k, v, dout = _inputs(D * 100 + G * 10 + T, B, T, S, G * Hkv, Hkv, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse, exp = _autograd(q, k, v, dout, **kw)
    got = ref.flash_attention_bwd_tiled(q, k, v, out, dout, lse, **kw)
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        torch.testing.assert_close(g, e, **TOL, msg=lambda m, name=name: f"{name}: {m}")


def test_tiled_backward_custom_scale_and_empty_rows():
    """A scale other than 1/sqrt(D), and a window that leaves every row
    past the cached keys empty (lse = -inf): zero gradient, never NaN."""
    q, k, v, dout = _inputs(5, 1, 70, 70, 4, 2, 64)
    kw = dict(softmax_scale=0.3)
    out, lse, exp = _autograd(q, k, v, dout, **kw)
    for g, e in zip(ref.flash_attention_bwd_tiled(q, k, v, out, dout, lse, **kw), exp):
        torch.testing.assert_close(g, e, **TOL)
    kw = dict(q_offset=200, window=1)             # keys 0..69, queries at 200..269
    out, lse, exp = _autograd(q, k, v, dout, **kw)
    assert torch.isinf(lse).all()
    for g in ref.flash_attention_bwd_tiled(q, k, v, out, dout, lse, **kw):
        assert torch.equal(g, torch.zeros_like(g))
    for e in exp:
        assert torch.equal(e, torch.zeros_like(e))


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, None), (True, 1, None), (True, 7, None), (True, 100, None), (False, None, None),
    (True, None, 0), (True, 33, 150), (True, 5, 64), (False, None, 17)])
def test_q_tile_range_inverts_kv_tile_range(causal, window, q_offset):
    """Key tile kt is in ``kv_tile_range`` of query tile qt exactly when qt
    is in ``q_tile_range`` of kt, and that is exactly when some row of qt
    sees some key of kt; over ragged T and S and several tile sizes."""
    for T, S, bq, bk in itertools.product((1, 37, 64, 130), (1, 40, 64, 200), (16, 64), (8, 32)):
        if causal and q_offset is None and S < T:
            continue
        offset = S - T if q_offset is None else q_offset
        n_q, n_k = -(-T // bq), -(-S // bk)
        for qt, kt in itertools.product(range(n_q), range(n_k)):
            first, end = flash_mod.kv_tile_range(qt * bq, bq, T, S, bk, causal, window,
                                                 q_offset)
            q_first, q_end = flash_mod.q_tile_range(kt * bk, bk, T, S, bq, causal, window,
                                                    q_offset)
            sees = any(
                not causal or (j <= t + offset and (window is None or t + offset - j < window))
                for t in range(qt * bq, min(qt * bq + bq, T))
                for j in range(kt * bk, min(kt * bk + bk, S)))
            assert (first <= kt < end) == sees == (q_first <= qt < q_end), \
                (T, S, bq, bk, qt, kt)


SHAPES = [(4, 512, 512, 16, 2, 128), (2, 100, 300, 16, 2, 64), (3, 1, 9, 6, 2, 32),
          (1, 379, 379, 10, 1, 256), (1, 448, 1500, 8, 8, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D", SHAPES)
def test_plan_covers_every_key_tile_and_head_once_heaviest_first(B, T, S, Hq, Hkv, D, dtype):
    """dK/dV: one block per (key tile, query head, batch), each once, the
    longest walks (under the causal mask) first; dQ: one block per (query
    tile, query head, batch), the tiles that see the most keys first."""
    p = bwd_mod.plan(B, T, S, Hq, Hkv, D, dtype)
    assert p.block_keys * p.key_tiles >= S > p.block_keys * (p.key_tiles - 1)
    coords = [bwd_mod.dkdv_block_coords(B, Hq, i) for i in range(p.dkdv_blocks)]
    assert sorted(coords) == sorted(itertools.product(range(B), range(Hq), range(p.key_tiles)))
    walks = [-operator.sub(*flash_mod.q_tile_range(kt * p.block_keys, p.block_keys, T, S,
                                                   p.rows, True, None))
             for _, _, kt in coords]
    assert walks == sorted(walks, reverse=True)
    coords = [bwd_mod.dq_block_coords(p, B, Hq, i) for i in range(p.dq_blocks)]
    assert sorted(coords) == sorted(itertools.product(range(B), range(Hq), range(p.q_tiles)))
    walks = [-operator.sub(*flash_mod.kv_tile_range(qt * bwd_mod.DQ_ROWS, bwd_mod.DQ_ROWS, T, S,
                                                    p.dq_keys, True, None))
             for _, _, qt in coords]
    assert walks == sorted(walks, reverse=True)
    assert p.partial == (Hq != Hkv)
    assert p.scratch_bytes == (2 * B * S * Hq * D * 4 if Hq != Hkv else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", flash_mod.HEAD_DIMS)
def test_plan_fits_shared_memory(D, dtype):
    """Every tile fits the 227 KB a block may have; the key tile is 64 keys
    (32 where two warps share 16 keys) and the ring stages hold whole
    k-steps of the type's mma (8 for TF32, 16 for bf16)."""
    p = bwd_mod.plan(1, 512, 512, 8, 2, D, dtype)
    assert p.dkdv_smem <= flash_mod.SMEM_LIMIT and p.dq_smem <= flash_mod.SMEM_LIMIT
    assert (p.dkdv_smem, p.dq_smem) == bwd_mod.smem_bytes(dtype, D)
    assert p.block_keys * p.split == 16 * bwd_mod.WARPS and D % (8 * p.split) == 0
    k_step = 8 if dtype == torch.float32 else 16
    assert p.rows % k_step == 0 and p.dq_keys % k_step == 0


def test_plan_fills_the_card_at_the_training_shape():
    """qwen2_5_3b's microbatch (B=4, T=S=512, 16 query heads over 2 of 128):
    at least two dK/dV blocks an SM of the H100's 132, and 16.8 MB of fp32
    partials each for dK and dV."""
    for dtype in (torch.float32, torch.bfloat16):
        p = bwd_mod.plan(4, 512, 512, 16, 2, 128, dtype)
        assert p.dkdv_blocks >= 2 * flash_mod.SMS and p.dq_blocks >= 2 * flash_mod.SMS
        assert p.partial and p.scratch_bytes == 2 * 16_777_216


def test_plan_raises_on_unknown_tiles():
    with pytest.raises(ValueError, match="no tiles"):
        bwd_mod.plan(1, 8, 8, 2, 2, 96, torch.float32)
    with pytest.raises(ValueError, match="no tiles"):
        bwd_mod.plan(1, 8, 8, 2, 2, 64, torch.float16)


def test_wrapper_constants_agree_with_the_source():
    """The plan's constants are the kernel's: warps, ring stages, dQ rows,
    the tile table and the shared-memory sums; every tile fits the 227 KB
    a block may have."""
    source = (KERNELS / "csrc" / "flash_attention_bwd.cu").read_text()
    assert f"constexpr int kWarps = {bwd_mod.WARPS};" in source
    assert f"constexpr int kStages = {bwd_mod.STAGES};" in source
    assert "constexpr int kDqRows = 16 * kWarps;" in source and bwd_mod.DQ_ROWS == 64
    ctype = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
    for (dtype, D), (rows, split, dq_keys) in bwd_mod.TILES.items():
        assert (f"template <> struct BwdTiles<{ctype[dtype]}, {D}> : "
                f"TilesOf<{rows}, {split}, {dq_keys}> {{}};") in source
    assert len(bwd_mod.TILES) == source.count("template <> struct BwdTiles<")
    assert ("kDkdvSmem = (2 * kKeys + 2 * kStages * kRows) * kLD * sizeof(T) +\n"
            "                                   2 * kStages * kRows * 4;") in source
    assert ("kDqSmem = (2 * kDqRows + 2 * kStages * kDqKeys) * kLD * sizeof(T) +\n"
            "                                 2 * kDqRows * 4;") in source
    assert "kKeys = 16 * kWarps / Tiles::kSplit;" in source
    # the shared memory of fp32 at D = 256: a dQ block holds 64 rows of Q and
    # dO and two stages of 16 keys of K and V, rows of 260 floats
    assert bwd_mod.smem_bytes(torch.float32, 256) == (133376, 200192)
    assert max(max(bwd_mod.smem_bytes(dt, D)) for dt, D in bwd_mod.TILES) <= flash_mod.SMEM_LIMIT


def test_wrapper_reads_no_device_value_and_has_no_fallback():
    """The wrapper plans from shapes alone (no .item(), .tolist(), .cpu() or
    .numpy()), and has no try around the launch: a CUDA tensor launches the
    kernel or raises."""
    tree = ast.parse((KERNELS / "flash_attention_bwd.py").read_text())
    reads = [node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)
             and node.attr in ("item", "tolist", "cpu", "numpy")]
    assert reads == []
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))


def test_wrapper_refuses_cpu_tensors():
    q, k, v, dout = _inputs(0, 1, 8, 8, 2, 2, 32)
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bwd_mod.flash_attention_bwd(q, k, v, out, dout, lse)


def test_cpu_autograd_goes_through_the_plain_version():
    """On the CPU ``ops.flash_attention`` with gradients is autograd through
    the plain version: no kernel is launched, and the gradients are those of
    ``ref.flash_attention_ref``."""
    q, k, v, dout = _inputs(1, 2, 21, 21, 8, 2, 32)
    ops.reset_launch_counts()
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(ops.flash_attention(qg, kg, vg, window=5), (qg, kg, vg), dout)
    assert not any(ops.launch_counts().values())
    _, _, exp = _autograd(q, k, v, dout, window=5)
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    assert math.isfinite(float(sum(g.sum() for g in got)))
