"""The port's Mamba2 path on the CPU against the JAX package.

* K3's plain version (``repro_torch.kernels.ref.ssd_scan_chunked``, what
  ``ops.ssd_scan`` runs on a CPU tensor) against the JAX package's sequential
  oracle ``ref.ssd_scan_ref`` and its Pallas ``ssd_scan`` in interpret mode,
  over the shape grid of ``tests/test_kernels.py`` at its tolerances: 2e-4 in
  fp32, 5e-4 at the property points, 2e-2 with bf16 inputs.
* What the Pallas kernel does not take: a ragged T and an initial state,
  against the exact sequential oracle.
* The SSD layers against the JAX layers on reduced ``mamba2_370m`` (1e-5),
  and the reduced model against the JAX ``prefill``/``decode_step`` (logits
  2e-3).  The JAX ``ssd_prefill`` asserts ``T % chunk == 0`` once T exceeds
  the chunk (fault F5 of the reference); the port takes any T and is held
  against the JAX model on lengths it accepts (37 = 32 + 5).

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models.convert import from_numpy
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)    # the suite runs in several workers at once

ARCH = "mamba2_370m"
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)


def _inputs(seed, B, T, H, P, N):
    """fp32 numpy inputs with realistic decays dA = -softplus(normal)."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dA = -np.logaddexp(0.0, rng.standard_normal((B, T, H))).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    return xdt, dA, Bm, Cm


def _jax(arrs, dtype="float32"):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype="float32"):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _close(out, exp, tol):
    np.testing.assert_allclose(out.numpy(), np.asarray(exp, np.float32), rtol=tol, atol=tol)


# =========================================================================
# K3's plain version
# =========================================================================

SSD_CASES = (
    [((1, 128, 2, 64, 32), 128, "float32", 2e-4),    # single chunk
     ((2, 256, 2, 64, 32), 128, "float32", 2e-4),    # two chunks: the recurrence
     ((1, 512, 1, 32, 64), 128, "float32", 2e-4),    # four chunks
     ((2, 64, 4, 16, 16), 32, "float32", 2e-4),      # small chunks
     ((1, 96, 2, 32, 32), 32, "float32", 2e-4),      # T a non-power-of-two multiple
     ((1, 128, 2, 32, 32), 64, "bfloat16", 2e-2)]    # bf16 inputs, fp32 accumulation
    # the reference's property sweep, as fixed (T_chunks, chunk, H, P, N) points
    + [((1, n * chunk, H, P, N), chunk, "float32", 5e-4)
       for n, chunk, H, P, N in [(1, 16, 1, 16, 16), (4, 64, 3, 32, 32), (2, 32, 2, 16, 32),
                                 (3, 16, 3, 32, 16), (1, 64, 2, 16, 16)]]
)


@pytest.mark.parametrize("shape,chunk,dtype,tol", SSD_CASES,
                         ids=[f"{s}-{c}-{d}" for s, c, d, _ in SSD_CASES])
def test_ssd_plain_matches_jax(shape, chunk, dtype, tol):
    arrs = _inputs(0, *shape)
    j = _jax(arrs, dtype)
    t = _torch(arrs, dtype)
    ops.reset_launch_counts()
    y, state = ops.ssd_scan(*t, chunk=chunk)
    assert not any(ops.launch_counts().values())
    B, T, H, P, N = shape
    assert y.shape == (B, T, H, P) and state.shape == (B, H, N, P)
    assert y.dtype == state.dtype == torch.float32
    y_ref, s_ref = jref.ssd_scan_ref(*j)
    y_pal, s_pal = pallas_ssd(*j, chunk=chunk, interpret=True)
    for exp_y, exp_s in ((y_ref, s_ref), (y_pal, s_pal)):
        _close(y, exp_y, tol)
        _close(state, exp_s, tol)


@pytest.mark.parametrize("T,chunk", [(37, 16), (5, 16), (130, 128), (379, 128)])
def test_ssd_ragged_with_initial_state_matches_oracle(T, chunk):
    """A ragged T and a carried state, which the Pallas kernel does not
    take, against the exact sequential oracle of both packages."""
    B, H, P, N = 2, 2, 16, 16
    arrs = _inputs(1, B, T, H, P, N)
    s0 = np.random.default_rng(2).standard_normal((B, H, N, P)).astype(np.float32)
    y, state = ops.ssd_scan(*_torch(arrs), chunk=chunk, initial_state=torch.from_numpy(s0))
    y_ref, s_ref = jref.ssd_scan_ref(*_jax(arrs), initial_state=jnp.asarray(s0))
    _close(y, y_ref, 2e-4)
    _close(state, s_ref, 2e-4)
    y_seq, s_seq = tref.ssd_scan_ref(*_torch(arrs), initial_state=torch.from_numpy(s0))
    _close(y_seq, y_ref, 1e-5)
    _close(s_seq, s_ref, 1e-5)


def test_ssd_state_continuation():
    """Scanning [0:T] equals scanning [0:20] then [20:T] with the carried
    state, at a split that leaves both parts ragged."""
    xdt, dA, Bm, Cm = _torch(_inputs(3, 1, 53, 2, 16, 16))
    y_full, s_full = ops.ssd_scan(xdt, dA, Bm, Cm, chunk=16)
    y_a, s_a = ops.ssd_scan(xdt[:, :20], dA[:, :20], Bm[:, :20], Cm[:, :20], chunk=16)
    y_b, s_b = ops.ssd_scan(xdt[:, 20:], dA[:, 20:], Bm[:, 20:], Cm[:, 20:], chunk=16,
                            initial_state=s_a)
    torch.testing.assert_close(torch.cat([y_a, y_b], 1), y_full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_b, s_full, rtol=1e-4, atol=1e-4)


# =========================================================================
# SSD layers and the reduced model
# =========================================================================

def _models(seed):
    cfg = jax_reduced_config(ARCH)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(seed), jnp.float32)
    tm = build_model(get_reduced_config(ARCH))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def test_ssd_layers_match_jax():
    cfg, _, jp, _, tp = _models(0)
    jb = jax.tree.map(lambda a: a[0], jp["blocks"]["ssd"])
    tb = {k: v[0] for k, v in tp["blocks"]["ssd"].items()}
    ssm = cfg.ssm
    H = ssm.num_heads(cfg.d_model)
    W = ssm.d_inner(cfg.d_model) + 2 * ssm.state_dim
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    state = rng.standard_normal((2, H, ssm.state_dim, ssm.head_dim)).astype(np.float32)
    conv = rng.standard_normal((2, ssm.conv_width - 1, W)).astype(np.float32)

    for t_out, j_out in zip(TL._ssd_split(cfg, tb, _t(x))[:3],
                            JL._ssd_split(cfg, jb, jnp.asarray(x))[:3]):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **LAYER_TOL)
    xbc = rng.standard_normal((2, 32, W)).astype(np.float32)
    for st in (None, conv):
        got = TL._causal_conv1d(_t(xbc), tb["conv"], None if st is None else _t(st))
        exp = JL._causal_conv1d(jnp.asarray(xbc), jb["conv"],
                                None if st is None else jnp.asarray(st))
        for g, e in zip(got, exp):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), **LAYER_TOL)
    # prefill, fresh and from a carried state; then one decode step
    for st, cv in ((None, None), (state, conv)):
        got = TL.ssd_prefill(cfg, tb, _t(x), None if st is None else _t(st),
                             None if cv is None else _t(cv))
        exp = JL.ssd_prefill(cfg, jb, jnp.asarray(x), None if st is None else jnp.asarray(st),
                             None if cv is None else jnp.asarray(cv))
        for g, e in zip(got, exp):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), **LAYER_TOL)
    got = TL.ssd_decode_step(cfg, tb, _t(x1), _t(state), _t(conv))
    exp = JL.ssd_decode_step(cfg, jb, jnp.asarray(x1), jnp.asarray(state), jnp.asarray(conv))
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **LAYER_TOL)
    # the chunked reference on its own signature (xh, dt, A)
    xh = rng.standard_normal((2, 32, H, ssm.head_dim)).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((2, 32, H))).astype(np.float32)
    A = -np.exp(np.asarray(jb["A_log"]))
    Bm, Cm = (rng.standard_normal((2, 32, ssm.state_dim)).astype(np.float32) for _ in range(2))
    got = TL.ssd_chunked_ref(_t(xh), _t(dt), _t(A), _t(Bm), _t(Cm), chunk=16,
                             initial_state=_t(state))
    exp = JL.ssd_chunked_ref(*(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)), chunk=16,
                             initial_state=jnp.asarray(state))
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **LAYER_TOL)


def test_prefill_decode_matches_jax():
    """prefill(32) then decode against the JAX model, and the cache's states
    against the JAX cache's."""
    cfg, jm, jp, tm, tp = _models(3)
    B, T = 2, 32
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T + 1))
    jc = jm.init_cache(B, 64, jnp.float32)
    jl_pre, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :T])}, jc)
    jl_dec, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, T:]))
    tc = tm.init_cache(B, 64, torch.float32, "cpu")
    tl_pre, tc = tm.prefill(tp, {"tokens": _t(toks[:, :T])}, tc)
    tl_dec, tc = tm.decode_step(tp, tc, _t(toks[:, T:]))
    assert tc["cache_len"].tolist() == [T + 1] * B
    np.testing.assert_allclose(tl_pre.numpy(), np.asarray(jl_pre), **LOGIT_TOL)
    np.testing.assert_allclose(tl_dec.numpy(), np.asarray(jl_dec), **LOGIT_TOL)
    for k in ("state", "conv"):
        assert tc["layers"][k].dtype == torch.float32
        np.testing.assert_allclose(tc["layers"][k].numpy(), np.asarray(jc["layers"][k]),
                                   **LOGIT_TOL)


def test_ragged_prefill_matches_jax_in_two_parts():
    """A 37-token prefill, which the JAX model refuses (F5: 37 % 16 != 0),
    equals the JAX model's 32 + 5; so do the port's own 16 + 21."""
    cfg, jm, jp, tm, tp = _models(4)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 37))
    with pytest.raises(AssertionError):
        jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(1, 64, jnp.float32))
    jc = jm.init_cache(1, 64, jnp.float32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :32])}, jc)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, 32:])}, jc)
    tl, _ = tm.prefill(tp, {"tokens": _t(toks)}, tm.init_cache(1, 64, torch.float32, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    tc = tm.init_cache(1, 64, torch.float32, "cpu")
    _, tc = tm.prefill(tp, {"tokens": _t(toks[:, :16])}, tc)
    tl2, _ = tm.prefill(tp, {"tokens": _t(toks[:, 16:])}, tc)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_decode_slots_touches_only_its_slots():
    """Decoding rows [2, 0] gives the logits of those rows decoded on their
    own and leaves row 1's states bit for bit as they were: a recurrent
    state has no position mask, so a stray write would corrupt it for good."""
    cfg, jm, jp, tm, tp = _models(5)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 10))
    nxt = rng.integers(0, cfg.vocab_size, (3, 1))
    cache = tm.init_cache(3, 32, torch.float32, "cpu")
    _, cache = tm.prefill(tp, {"tokens": _t(toks)}, cache)
    before = {k: v[:, 1].clone() for k, v in cache["layers"].items()}
    logits = tm.decode_slots(tp, cache, _t(nxt[[2, 0]]), torch.tensor([2, 0]))
    for k, v in cache["layers"].items():
        assert torch.equal(v[:, 1], before[k]), k
    assert cache["cache_len"].tolist() == [11, 10, 11]
    for i, row in enumerate((2, 0)):
        jc = jm.init_cache(1, 32, jnp.float32)
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[row:row + 1])}, jc)
        jl, _ = jm.decode_step(jp, jc, jnp.asarray(nxt[row:row + 1]))
        np.testing.assert_allclose(logits[i:i + 1].numpy(), np.asarray(jl), **LOGIT_TOL)


def test_param_count_and_fp32_leaves():
    """Parameter counts equal the config's; the leaves the reference keeps in
    fp32 (A_log, D, dt_bias) stay fp32 in a bf16 model, from ``init`` and
    from ``from_numpy``; the SSD cache is fp32 in a bf16 cache."""
    cfg = get_reduced_config(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    _, _, jp, _, _ = _models(0)
    converted = from_numpy(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.bfloat16)

    def leaves(tree, name=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, k)
        else:
            yield name, tree

    for tree in (params, converted):
        assert sum(t.numel() for _, t in leaves(tree)) == cfg.param_count()
        for name, t in leaves(tree):
            want = torch.float32 if name in ("A_log", "D", "dt_bias") else torch.bfloat16
            assert t.dtype == want, name
    cache = model.init_cache(2, 24, torch.bfloat16, "cpu")
    assert {k: v.dtype for k, v in cache["layers"].items()} == {
        "state": torch.float32, "conv": torch.float32}
