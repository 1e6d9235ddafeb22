"""K3's forward as its kernels compute it, on the CPU.

* ``ref.ssd_scan_two_pass_tiled`` (the two launches' strips and 3xTF32
  products, L and exp(cum) on the left operand before the split) against the
  JAX package's sequential oracle and its Pallas kernel in interpret mode on
  the shapes of ``tests/test_kernels.py``, over chunks of 16, 64 and 128 and
  N from 4 to 128; on ragged T with a carried initial state against the
  oracle, which takes one.
* One TF32 pass in place of three misses the fp32 bar, so the bar holds
  the mirror to 3xTF32; from bf16 inputs one TF32 pass of C·Bᵀ gives the
  bits of three (the kernel takes one there).
* The wrapper's layout (column tile, chunks, scratch) against the source's
  constants; the wrapper reads no device value and has no ``try``; the
  CUDA-core product path is gone.

Tolerances are the reference's (``tests/test_kernels.py``): 2e-4 in fp32,
5e-4 at the SSD property points, 2e-2 in bf16.  Inputs are made with numpy
from a seed and handed to both packages.
"""

import ast
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as ssd_mod

torch.set_num_threads(2)    # the suite runs in several workers at once

KERNELS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "kernels"


def _inputs(seed, B, T, H, P, N):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dA = -np.logaddexp(0.0, rng.standard_normal((B, T, H))).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    return xdt, dA, Bm, Cm


def _close(out, exp, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


# the shapes of tests/test_kernels.py (its property sweep as fixed points, at
# 5e-4), then chunks of 16, 64 and 128 over N from 4 to 128
TILED_CASES = (
    [((1, 128, 2, 64, 32), 128, "float32", 2e-4),
     ((2, 256, 2, 64, 32), 128, "float32", 2e-4),
     ((1, 512, 1, 32, 64), 128, "float32", 2e-4),
     ((2, 64, 4, 16, 16), 32, "float32", 2e-4),
     ((1, 96, 2, 32, 32), 32, "float32", 2e-4),
     ((1, 128, 2, 32, 32), 64, "bfloat16", 2e-2)]
    + [((1, n * chunk, H, P, N), chunk, "float32", 5e-4)
       for n, chunk, H, P, N in [(1, 16, 1, 16, 16), (4, 64, 3, 32, 32), (2, 32, 2, 16, 32),
                                 (3, 16, 3, 32, 16), (1, 64, 2, 16, 16)]]
    + [((1, 64, 2, 16, 4), 16, "float32", 2e-4),
       ((1, 128, 1, 16, 12), 64, "float32", 2e-4),
       ((2, 256, 1, 16, 100), 128, "float32", 2e-4),
       ((1, 256, 2, 16, 128), 128, "float32", 2e-4),
       ((1, 128, 1, 32, 128), 64, "float32", 2e-4)]
)


@pytest.mark.parametrize("shape,chunk,dtype,tol", TILED_CASES,
                         ids=[f"{s}-{c}-{d}" for s, c, d, _ in TILED_CASES])
def test_ssd_tiled_matches_jax(shape, chunk, dtype, tol):
    arrs = _inputs(0, *shape)
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    y, state = tref.ssd_scan_two_pass_tiled(*t, chunk=chunk)
    B, T, H, P, N = shape
    assert y.shape == (B, T, H, P) and state.shape == (B, H, N, P)
    assert y.dtype == state.dtype == torch.float32
    for exp_y, exp_s in (jref.ssd_scan_ref(*j), pallas_ssd(*j, chunk=chunk, interpret=True)):
        _close(y, exp_y, tol)
        _close(state, exp_s, tol)


@pytest.mark.parametrize("T,chunk,N", [(5, 16, 4), (37, 16, 16), (130, 128, 8),
                                       (379, 128, 128), (200, 64, 20), (1, 16, 100)])
def test_ssd_tiled_ragged_with_initial_state(T, chunk, N):
    """Ragged T and a carried state (what the Pallas kernel does not take)
    against the JAX oracle with the same initial state."""
    B, H, P = 2, 2, 16
    arrs = _inputs(1, B, T, H, P, N)
    s0 = np.random.default_rng(2).standard_normal((B, H, N, P)).astype(np.float32)
    y, state = tref.ssd_scan_two_pass_tiled(*(torch.from_numpy(a) for a in arrs), chunk=chunk,
                                            initial_state=torch.from_numpy(s0))
    exp_y, exp_s = jref.ssd_scan_ref(*(jnp.asarray(a) for a in arrs),
                                     initial_state=jnp.asarray(s0))
    _close(y, exp_y, 2e-4)
    _close(state, exp_s, 2e-4)


@pytest.mark.parametrize("shape,chunk", [((2, 256, 2, 64, 32), 128), ((1, 64, 2, 16, 4), 16),
                                         ((1, 256, 2, 16, 128), 128)])
def test_ssd_tiled_one_tf32_pass_misses_the_bar(shape, chunk):
    """The 2e-4 bar is tight enough to tell 3xTF32 from one TF32 pass: the
    mirror with every product as one pass misses it against the JAX oracle
    where the 3xTF32 mirror meets it (test_ssd_tiled_matches_jax)."""
    arrs = _inputs(0, *shape)
    exp_y, _ = jref.ssd_scan_ref(*(jnp.asarray(a) for a in arrs))
    y, _ = tref.ssd_scan_two_pass_tiled(*(torch.from_numpy(a) for a in arrs), chunk=chunk,
                                        matmul=tref.matmul_tf32)
    with pytest.raises(AssertionError):
        _close(y, exp_y, 2e-4)


def test_ssd_tiled_one_pass_is_three_from_bf16():
    """C·Bᵀ from bf16 values: both operands are exact in TF32, so one TF32
    pass gives the same bits as 3xTF32 (the kernel takes one pass there)."""
    rng = np.random.default_rng(3)
    C = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
    C, Bm = C.bfloat16().float(), Bm.bfloat16().float()
    assert torch.equal(tref.tf32_round(C), C)
    assert torch.equal(tref.matmul_tf32(C, Bm.T), tref.matmul_3xtf32(C, Bm.T))


def _constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


@pytest.mark.parametrize("B,T,H,P,N,chunk,tile", [
    (1, 512, 32, 64, 128, 128, 64), (4, 2048, 32, 64, 128, 128, 64),
    (1, 379, 8, 64, 128, 128, 64), (2, 37, 2, 48, 20, 16, 16), (1, 5, 3, 96, 4, 16, 32),
    (3, 2000, 4, 32, 32, 32, 32)])
def test_ssd_fwd_plan(B, T, H, P, N, chunk, tile):
    """The wrapper's layout against the source: the longest chunk and the
    largest N it admits, the column tile (one the source instantiates), the
    chunks, and the scratch the C interface names: CB (B, chunks, Q, Q), the
    flags one per (chunk, head, column tile), cumx 3Q words a (chunk, head)."""
    source = (KERNELS / "csrc" / "ssd_scan.cu").read_text()
    tile_src = (KERNELS / "csrc" / "ssd_tile.cuh").read_text()
    assert _constant(tile_src, "kMaxQ") == ssd_mod.MAX_CHUNK
    assert _constant(tile_src, "kMaxN") == ssd_mod.MAX_STATE
    assert ssd_mod.col_tile(P) == tile and P % tile == 0
    assert f"return launch_tile<T, {tile}>(" in source
    chunks = ssd_mod.n_chunks(T, chunk)
    assert chunks == -(-T // chunk)
    assert ssd_mod.scratch_shapes(B, T, H, P, N, chunk) == (
        (B, chunks, chunk, chunk), (B, chunks, H, N, P), (B, chunks, H, N, P), (B, chunks, H),
        (B, chunks, H, P // tile), (B, chunks, H, 3 * chunk))
    assert "flags (B, chunks, H, P / col_tile) int32" in source
    assert "cumx (B, chunks, H, 3Q" in source


def test_ssd_wrapper_reads_no_device_value_and_has_no_try():
    """The wrapper plans from shapes alone (so the call can be captured in a
    CUDA graph) and never falls back: no .item(), .tolist(), .cpu() or
    .numpy(), and no try."""
    tree = ast.parse((KERNELS / "ssd_scan.py").read_text())
    reads = [node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)
             and node.attr in ("item", "tolist", "cpu", "numpy")]
    assert reads == []
    assert not [node for node in ast.walk(tree) if isinstance(node, ast.Try)]


def test_ssd_fwd_has_no_cuda_core_product():
    """Every product of K3's forward is Mma<float>'s: the register-tiled
    fp32 path and its helpers are gone from the sources."""
    sources = {f.name: f.read_text() for f in (KERNELS / "csrc").iterdir()}
    for name in ("mma_slice", "load_cols", "col_of", "kLDA", "kLDB", "kMaxPT"):
        assert not [f for f, text in sources.items() if re.search(rf"\b{name}\b", text)], name
    scan = sources["ssd_scan.cu"]
    assert "MF::mma_pass" in scan and "fmaf(a[r]" not in scan
