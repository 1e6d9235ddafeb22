"""The fp32 kernels' tensor-core arithmetic, 3xTF32, in plain PyTorch on the CPU.

K1's fp32 forward and K1-bwd (``csrc/mma.cuh``) multiply fp32 operands on
the tensor cores as three TF32 products: each operand split into
big = tf32(x) and small = tf32(x - big), and small·big + big·small +
big·big summed in fp32.  ``ref.tf32_round`` and ``ref.matmul_3xtf32`` are
that arithmetic; ``ref.matmul_tf32`` is one TF32 pass.  Held here, on
seeded numpy inputs, against fp64:

* ``tf32_round`` keeps 10 mantissa bits and rounds ties away from zero;
* at the tile sizes of K1's fp32 kernel and K1-bwd at D 32-256 (the
  kernels' products, a block's or a warp's), three passes stay within 1e-6
  of the largest exact entry and one pass does not come within 1e-4;
* K1's fp32 tiles (``ref.flash_attention_tiled_f32``) with every product
  in 3xTF32 hold the forward's 2e-4 against the fp64 plain version and the
  JAX package's reference, and with one TF32 pass do not hold it;
* K1-bwd's tiles (``ref.flash_attention_bwd_tiled``) with every product in
  3xTF32 hold 1e-3 of the largest gradient entry against autograd through
  the fp64 plain version and ``jax.grad`` of the JAX reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import flash_attention_bwd as bwd_mod
from repro_torch.kernels import ref

torch.set_num_threads(2)    # the suite runs in several workers at once


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _rel(got, exact):
    """Largest error over the largest exact entry."""
    return float((got.double() - exact).abs().max() / exact.abs().max())


def test_tf32_round_keeps_ten_mantissa_bits_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                                   # TF32's unit at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, -(one + 3 * ulp / 2), 3.0, 0.0], dtype=torch.float32)
    exp = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, -(one + 2 * ulp), 3.0, 0.0])
    assert torch.equal(ref.tf32_round(x), exp)
    (r,) = _arrays([(4096,)], 0)
    r = torch.from_numpy(r) * 1e3
    got = ref.tf32_round(r)
    assert not (got.view(torch.int32) & 0x1FFF).any()            # 13 low bits zero
    assert float(((got - r).abs() / r.abs()).max()) <= 2.0 ** -11
    big = ref.tf32_round(r)
    small = ref.tf32_round(r - big)
    assert float(((big + small - r).abs() / r.abs()).max()) <= 2.0 ** -21


def _tile_products():
    """(rows, inner, columns) of every product of the fp32 kernels at D
    32-256: K1's 64-row block (S = Q Kᵀ, O += P V), K1-bwd's 16-key and
    16-row warps (Sᵀ = K Qᵀ, dV += Pᵀ dO on a warp's columns, S = Q Kᵀ and
    dQ += dS K)."""
    out = set()
    for D in flash_mod.HEAD_DIMS:
        bk = flash_mod.F32_KEYS[D]
        rows, split, dq_keys = bwd_mod.TILES[(torch.float32, D)]
        out |= {(64, D, bk), (64, bk, D), (16, D, rows), (16, rows, D // split),
                (16, D, dq_keys), (16, dq_keys, D)}
    return sorted(out)


@pytest.mark.parametrize("m,k,n", _tile_products())
def test_three_passes_hold_1e_6_and_one_pass_does_not(m, k, n):
    a, b = _arrays(((m, k), (k, n)), m * 1000 + k * 10 + n)
    exact = torch.from_numpy(a).double() @ torch.from_numpy(b).double()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert _rel(ref.matmul_3xtf32(ta, tb), exact) <= 1e-6
    assert _rel(ref.matmul_tf32(ta, tb), exact) > 1e-4         # about three digits


# (B, T, S, Hq, Hkv, D), kwargs: qwen2_5_3b's training heads, a window with
# G = 2, D = 32, recurrentgemma's heads with its kind of window, whisper's
# non-causal shape with S off the tiles, and rows that see no key
ATTN = [((1, 256, 256, 16, 2, 128), {}), ((2, 100, 300, 4, 2, 64), {"window": 40}),
        ((1, 70, 70, 2, 1, 32), {}), ((1, 130, 333, 10, 1, 256), {"window": 64}),
        ((1, 50, 150, 8, 8, 64), {"causal": False}),
        ((1, 64, 200, 4, 4, 32), {"q_offset": 200, "window": 40})]


def _jax_kw(kw):
    return None if "q_offset" in kw else kw


@pytest.mark.parametrize("case", range(len(ATTN)), ids=[f"{s}-{k}" for s, k in ATTN])
def test_forward_tiles_in_3xtf32_hold_2e_4(case):
    (B, T, S, Hq, Hkv, D), kw = ATTN[case]
    arrs = _arrays(((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)), 100 + case)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    exact, exact_lse = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                               return_lse=True, **kw)
    out, lse = ref.flash_attention_tiled_f32(q, k, v, matmul=ref.matmul_3xtf32,
                                             return_lse=True, **kw)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out.double(), exact, rtol=2e-4, atol=2e-4)
    assert torch.equal(torch.isinf(lse), torch.isinf(exact_lse))
    seen = ~torch.isinf(exact_lse)
    torch.testing.assert_close(lse[seen].double(), exact_lse[seen].double(), rtol=2e-4, atol=2e-4)
    if _jax_kw(kw) is not None:
        jax_out = np.asarray(jref.flash_attention_ref(*(jnp.asarray(a) for a in arrs), **kw))
        np.testing.assert_allclose(out.numpy(), jax_out, rtol=2e-4, atol=2e-4)
    one_pass = ref.flash_attention_tiled_f32(q, k, v, matmul=ref.matmul_tf32, **kw).double()
    excess = float(((one_pass - exact).abs() - 2e-4 * (1 + exact.abs())).max())
    assert excess > 0, "one TF32 pass should not hold 2e-4"


# (B, T, S, Hq, Hkv, D), kwargs: G 1, 8 and 10; D 32-256; T and S off the
# tiles; S = 1; windows, non-causal (whisper's cross shape, cut), rows that
# see no key
BWD = [((1, 192, 192, 16, 2, 128), {}), ((2, 37, 37, 8, 1, 32), {}),
       ((1, 100, 100, 10, 1, 256), {"window": 33}), ((1, 1, 1, 2, 2, 64), {}),
       ((1, 70, 70, 4, 2, 64), {"window": 1}), ((1, 45, 300, 8, 8, 64), {"causal": False}),
       ((1, 64, 200, 4, 4, 32), {"q_offset": 200, "window": 40}),
       ((1, 83, 83, 10, 1, 128), {})]


@pytest.mark.parametrize("case", range(len(BWD)), ids=[f"{s}-{k}" for s, k in BWD])
def test_backward_tiles_in_3xtf32_hold_1e_3(case):
    (B, T, S, Hq, Hkv, D), kw = BWD[case]
    arrs = _arrays(((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, T, Hq, D)), 200 + case)
    q, k, v, dout = (torch.from_numpy(a) for a in arrs)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    out64, lse64 = ref.flash_attention_ref(*leaves, return_lse=True, **kw)
    exact = torch.autograd.grad(out64, leaves, dout.double())
    out, lse = ref.flash_attention_tiled_f32(q, k, v, matmul=ref.matmul_3xtf32,
                                             return_lse=True, **kw)
    got = ref.flash_attention_bwd_tiled(q, k, v, out, dout, lse, matmul=ref.matmul_3xtf32, **kw)
    largest = max(float(e.abs().max()) for e in exact)
    for name, g, e in zip(("dq", "dk", "dv"), got, exact):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert float((g.double() - e).abs().max()) <= 1e-3 * largest, name
    if _jax_kw(kw) is not None:
        jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
        _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, **kw), jq, jk, jv)
        for name, g, e in zip(("dq", "dk", "dv"), got, vjp(jdo)):
            assert float(np.abs(g.numpy() - np.asarray(e)).max()) <= 1e-3 * largest, name
