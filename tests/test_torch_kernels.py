"""The port's attention kernels on the CPU: their plain versions against the
JAX package's references and its Pallas kernels (interpret mode).

The same inputs, made with numpy from a seed, go to both packages; bf16
cases round the same fp32 arrays to bf16 on each side.  Tolerances are the
reference's own (``tests/test_kernels.py``): 2e-4 in fp32, 2e-2 in bf16.
On the CPU the dispatch layer must take the plain version and never touch a
CUDA kernel; the kernels themselves are checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as paged_mod
from repro_torch.kernels import ref as tref

REPO = Path(__file__).resolve().parent.parent
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _pair(arr: np.ndarray, dtype: str):
    """One fp32 numpy array as (jax array, torch tensor) of ``dtype``."""
    j = jnp.asarray(arr, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.array(arr, np.float32)).to(getattr(torch, dtype))
    return j, t


def _close(out: torch.Tensor, exp, dtype: str) -> None:
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# =========================================================================
# flash attention (K1)
# =========================================================================

FLASH_CASES = (
    [(shape, dt, {}) for shape in [
        (1, 128, 128, 4, 4, 64),        # MHA square
        (2, 128, 256, 8, 2, 64),        # GQA, chunked prefill (q = last T of S)
        (1, 64, 64, 4, 1, 128),         # MQA, D=128
        (1, 100, 100, 2, 2, 64),        # non-multiple-of-block T
        (1, 32, 160, 4, 4, 32),         # small D, long KV
    ] for dt in ("float32", "bfloat16")]
    + [((1, 128, 128, 4, 2, 64), "float32", {"window": w}) for w in (16, 64, 4096)]
    + [((2, 64, 64, 4, 4, 64), "float32", {"causal": False}),
       ((1, 64, 64, 2, 2, 64), "float32", {"softmax_scale": 0.5})]
    # the reference's property sweep, as fixed (T, S, Hkv, G, D) points
    + [((1, T, T + extra, Hkv * G, Hkv, D), "float32", {})
       for T, extra, Hkv, G, D in [(8, 0, 1, 1, 32), (33, 16, 2, 2, 64),
                                   (64, 93, 1, 4, 32), (127, 0, 2, 4, 64),
                                   (127, 93, 2, 1, 32), (33, 93, 1, 2, 64)]]
)


@pytest.mark.parametrize("shape,dtype,kw", FLASH_CASES,
                         ids=[f"{s}-{d}-{k}" for s, d, k in FLASH_CASES])
def test_flash_plain_matches_jax(shape, dtype, kw):
    B, T, S, Hq, Hkv, D = shape
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(s), dtype)
        for s in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    ops.reset_launch_counts()
    out = ops.flash_attention(tq, tk, tv, **kw)
    assert out.shape == (B, T, Hq, D) and out.dtype == tq.dtype
    assert ops.launch_counts() == {"flash_attention": 0, "paged_attention": 0}
    _close(out, jref.flash_attention_ref(jq, jk, jv, **kw), dtype)
    _close(out, pallas_flash(jq, jk, jv, interpret=True, **kw), dtype)


# =========================================================================
# paged attention (K2)
# =========================================================================

def _paged_np(rng, B, Hq, Hkv, D, page, pps, num_pages=None):
    num_pages = num_pages or (B * pps + 1)
    q = rng.standard_normal((B, Hq, D))
    kp = rng.standard_normal((num_pages, page, Hkv, D))
    vp = rng.standard_normal((num_pages, page, Hkv, D))
    tables = np.arange(B * pps, dtype=np.int32).reshape(B, pps)
    ctx = rng.integers(1, page * pps + 1, size=B).astype(np.int32)
    return q, kp, vp, tables, ctx


PAGED_CASES = (
    [(shape, dt) for shape in [
        (2, 4, 4, 64, 16, 4),      # MHA
        (3, 8, 2, 64, 16, 3),      # GQA
        (1, 4, 1, 128, 32, 2),     # MQA, D=128
        (4, 2, 2, 32, 8, 5),       # small heads
    ] for dt in ("float32", "bfloat16")]
    # the reference's property sweep, as fixed (B, Hkv, G, page, pps) points
    + [((B, Hkv * G, Hkv, 32, page, pps), "float32")
       for B, Hkv, G, page, pps in [(1, 1, 1, 8, 1), (4, 2, 4, 16, 5),
                                    (3, 1, 2, 8, 3), (2, 2, 2, 16, 2)]]
)


def _check_paged(q, kp, vp, tables, ctx, dtype):
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(kp, dtype)
    jv, tv = _pair(vp, dtype)
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    jc, tc = jnp.asarray(ctx), torch.from_numpy(ctx)
    ops.reset_launch_counts()
    out = ops.paged_attention(tq, tk, tv, tt, tc)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    assert ops.launch_counts() == {"flash_attention": 0, "paged_attention": 0}
    _close(out, jref.paged_attention_ref(jq, jk, jv, jt, jc), dtype)
    _close(out, pallas_paged(jq, jk, jv, jt, jc, interpret=True), dtype)


@pytest.mark.parametrize("shape,dtype", PAGED_CASES,
                         ids=[f"{s}-{d}" for s, d in PAGED_CASES])
def test_paged_plain_matches_jax(shape, dtype):
    _check_paged(*_paged_np(np.random.default_rng(0), *shape), dtype)


def test_paged_scattered_tables():
    """Non-contiguous page assignment (realistic after frees/reuse)."""
    q, kp, vp, _, _ = _paged_np(np.random.default_rng(7), 2, 4, 2, 64, 16, 3,
                                num_pages=32)
    tables = np.array([[31, 2, 17], [9, 25, 0]], np.int32)
    _check_paged(q, kp, vp, tables, np.array([40, 33], np.int32), "float32")


def test_paged_single_token_context():
    """ctx=1: softmax over one key must return exactly that value row."""
    q, kp, vp, tables, _ = _paged_np(np.random.default_rng(8), 1, 2, 2, 32, 8, 2)
    _check_paged(q, kp, vp, tables, np.array([1], np.int32), "float32")


# =========================================================================
# dispatch and wrappers without a card
# =========================================================================

def test_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches or raises; it never computes on the CPU."""
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_attention(q, q[:, :, :1], q[:, :, :1])
    qp = torch.zeros(1, 2, 64)
    pages = torch.zeros(2, 16, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        paged_mod.paged_attention(qp, pages, pages, torch.zeros(1, 2, dtype=torch.int32),
                                  torch.ones(1, dtype=torch.int32))
    assert (flash_mod.launches, paged_mod.launches) == (0, 0)


def test_force_plain_and_unknown_force():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 1, 32)).astype(np.float32))
    torch.testing.assert_close(ops.flash_attention(q, k, k, force="plain"),
                               tref.flash_attention_ref(q, k, k))
    with pytest.raises(ValueError, match="force"):
        ops.flash_attention(q, k, k, force="kernel")


def test_kernel_modules_import_without_toolchain():
    """Importing the wrappers builds nothing and needs neither nvcc nor
    triton: a fresh interpreter with an empty PATH imports them all."""
    code = ("import sys; import repro_torch.kernels.ops; "
            "from repro_torch.kernels import _build; "
            "assert not _build._libs, _build._libs; "
            "assert 'triton' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "",
                              "PYTHONDONTWRITEBYTECODE": "1"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
