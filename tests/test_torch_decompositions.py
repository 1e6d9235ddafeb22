"""The CUDA kernels' own decompositions, in plain PyTorch, on the CPU.

* K2 splits each context into partitions and merges fp32 partials
  (``ref.paged_attention_split``); held against the JAX package's
  ``paged_attention_ref`` and its Pallas kernel in interpret mode over
  several partition lengths, with contexts of 0, 1, one partition, one key
  past a partition edge and the whole table, over scattered tables.
* K3 runs in two passes, C·Bᵀ and each chunk's state contribution first,
  then state passing and the output (``ref.ssd_scan_two_pass``); held
  against the JAX sequential oracle and the Pallas kernel in interpret mode
  on the shapes of ``tests/test_kernels.py``, and on ragged T with carried
  states against the port's sequential oracle.
* The wrappers' host-side planning: partition counts from
  ``pages_per_seq``, scratch shapes, column tiles, and no read of a device
  value.

Tolerances are the reference's (``tests/test_kernels.py``): 2e-4 in fp32,
5e-4 at the SSD property points, 2e-2 in bf16.  Inputs are made with numpy
from a seed and handed to both packages.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import paged_attention as paged_mod
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as ssd_mod

torch.set_num_threads(2)    # the suite runs in several workers at once

KERNELS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "kernels"
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _close(out, exp, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


# =========================================================================
# K2: split and merge
# =========================================================================

PAGE, PPS = 16, 20          # 320 keys a table row


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("partition", [16, 48, 128, 256])
def test_paged_split_matches_jax(partition, dtype):
    B, Hq, Hkv, D = 5, 4, 2, 32
    rng = np.random.default_rng(partition)
    num_pages = B * PPS + 3
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((num_pages, PAGE, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((num_pages, PAGE, Hkv, D)).astype(np.float32)
    tables = rng.permutation(num_pages)[:B * PPS].astype(np.int32).reshape(B, PPS)
    ctx = np.array([0, 1, partition, partition + 1, PPS * PAGE], np.int32)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, kp, vp))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, kp, vp))
    out = tref.paged_attention_split(tq, tk, tv, torch.from_numpy(tables),
                                     torch.from_numpy(ctx), partition=partition)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    pallas = pallas_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(ctx), interpret=True)
    _close(out, pallas, TOL[dtype])
    # the reference averages V over the whole table for an empty context;
    # the Pallas kernel and the split give 0 there
    assert float(out[0].abs().max()) == 0.0
    exp = jref.paged_attention_ref(jq, jk, jv, jnp.asarray(tables), jnp.asarray(ctx))
    _close(out[1:], np.asarray(exp, np.float32)[1:], TOL[dtype])


def test_paged_partials_of_empty_partitions():
    """A partition at or past the context contributes m = -inf, l = 0,
    acc = 0, and the merge ignores it."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 2, 32)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((8, 8, 1, 32)).astype(np.float32))
    tables = torch.arange(8, dtype=torch.int32).view(2, 4)
    ctx = torch.tensor([9, 0], dtype=torch.int32)
    m, l, acc = tref.paged_attention_partials(q, kp, kp, tables, ctx, partition=8)
    assert m.shape == l.shape == (2, 2, 4) and acc.shape == (2, 2, 4, 32)
    assert torch.isfinite(m[0, :, :2]).all() and torch.isinf(m[0, :, 2:]).all()
    assert torch.isinf(m[1]).all() and not l[1].any() and not acc[1].any()
    assert (l[0, :, 1] == 1.0).all()        # one visible key in the second partition
    torch.testing.assert_close(tref.paged_attention_merge(m, l, acc)[0],
                               tref.paged_attention_ref(q, kp, kp, tables, ctx)[0])


# =========================================================================
# K3: two passes
# =========================================================================

def _ssd_inputs(seed, B, T, H, P, N):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dA = -np.logaddexp(0.0, rng.standard_normal((B, T, H))).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    return xdt, dA, Bm, Cm


SSD_CASES = (
    [((1, 128, 2, 64, 32), 128, "float32", 2e-4),
     ((2, 256, 2, 64, 32), 128, "float32", 2e-4),
     ((1, 512, 1, 32, 64), 128, "float32", 2e-4),
     ((2, 64, 4, 16, 16), 32, "float32", 2e-4),
     ((1, 96, 2, 32, 32), 32, "float32", 2e-4),
     ((1, 128, 2, 32, 32), 64, "bfloat16", 2e-2)]
    + [((1, n * chunk, H, P, N), chunk, "float32", 5e-4)
       for n, chunk, H, P, N in [(1, 16, 1, 16, 16), (4, 64, 3, 32, 32), (2, 32, 2, 16, 32),
                                 (3, 16, 3, 32, 16), (1, 64, 2, 16, 16)]]
)


@pytest.mark.parametrize("shape,chunk,dtype,tol", SSD_CASES,
                         ids=[f"{s}-{c}-{d}" for s, c, d, _ in SSD_CASES])
def test_ssd_two_pass_matches_jax(shape, chunk, dtype, tol):
    arrs = _ssd_inputs(0, *shape)
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    y, state = tref.ssd_scan_two_pass(*t, chunk=chunk)
    B, T, H, P, N = shape
    assert y.shape == (B, T, H, P) and state.shape == (B, H, N, P)
    assert y.dtype == state.dtype == torch.float32
    for exp_y, exp_s in (jref.ssd_scan_ref(*j), pallas_ssd(*j, chunk=chunk, interpret=True)):
        _close(y, exp_y, tol)
        _close(state, exp_s, tol)


@pytest.mark.parametrize("T,chunk", [(5, 16), (37, 16), (130, 128), (379, 128), (200, 64)])
def test_ssd_two_pass_ragged_with_initial_state(T, chunk):
    """Ragged T and a carried state against the port's exact sequential
    oracle; the first pass's outputs recombine to the final state."""
    B, H, P, N = 2, 2, 16, 16
    t = [torch.from_numpy(a) for a in _ssd_inputs(1, B, T, H, P, N)]
    s0 = torch.from_numpy(np.random.default_rng(2).standard_normal((B, H, N, P))
                          .astype(np.float32))
    y, state = tref.ssd_scan_two_pass(*t, chunk=chunk, initial_state=s0)
    y_seq, s_seq = tref.ssd_scan_ref(*t, initial_state=s0)
    torch.testing.assert_close(y, y_seq, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(state, s_seq, rtol=2e-4, atol=2e-4)
    CBt, cum, dS, decay = tref.ssd_chunk_pass(*t, chunk=chunk)
    nc = -(-T // chunk)
    assert CBt.shape == (B, nc, chunk, chunk) and cum.dtype == torch.float64
    assert (dS.shape, decay.shape) == ((B, nc, H, N, P), (B, nc, H))
    s = s0
    for c in range(nc):
        s = s * decay[:, c, :, None, None] + dS[:, c]
    torch.testing.assert_close(s, s_seq, rtol=2e-4, atol=2e-4)


# =========================================================================
# the wrappers' host-side planning
# =========================================================================

@pytest.mark.parametrize("pps,page,parts", [
    (128, 16, 32), (1, 8, 1), (9, 8, 2), (20, 16, 5), (0, 16, 1)])
def test_paged_plan_counts_partitions_from_the_table(pps, page, parts):
    # the kernel sizes its grid by its own constant; the wrapper's scratch
    # must agree with it
    source = (KERNELS / "csrc" / "paged_attention.cu").read_text()
    assert f"constexpr int kPartition = {paged_mod.PARTITION};" in source
    assert paged_mod.plan(pps, page) == parts
    assert paged_mod.scratch_shapes(8, 32, 128, parts) == (
        (8, 32, parts), (8, 32, parts), (8, 32, parts, 128))


def test_paged_plan_refuses_partitions_off_the_page_grid():
    assert paged_mod.PARTITION % max(paged_mod.PAGE_SIZES) == 0
    with pytest.raises(ValueError, match="multiple of the page size"):
        paged_mod.plan(4, 48)


@pytest.mark.parametrize("B,T,H,P,chunk,tile", [
    (1, 512, 32, 64, 128, 64), (1, 379, 32, 64, 128, 64), (2, 100, 4, 32, 32, 32),
    (1, 128, 2, 96, 128, 32), (2, 37, 2, 48, 16, 16)])
def test_ssd_plan(B, T, H, P, chunk, tile):
    N = 128
    assert ssd_mod.col_tile(P) == tile
    nc = -(-T // chunk)
    assert ssd_mod.scratch_shapes(B, T, H, P, N, chunk) == (
        (B, nc, chunk + N, chunk), (B, nc, H, N, P), (B, nc, H, N, P), (B, nc, H),
        (B, nc, H, P // tile))


@pytest.mark.parametrize("module", ["paged_attention.py", "ssd_scan.py"])
def test_wrappers_read_no_device_value(module):
    """The wrappers plan from shapes alone, so that a decode step can be
    captured in a CUDA graph: no .item(), .tolist(), .cpu() or .numpy()."""
    tree = ast.parse((KERNELS / module).read_text())
    reads = [node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)
             and node.attr in ("item", "tolist", "cpu", "numpy")]
    assert reads == []
