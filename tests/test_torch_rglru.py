"""RecurrentGemma's path in the port against the JAX package on the CPU, in fp32.

* The RG-LRU layer: ``_causal_conv1d``, ``rglru`` and ``rglru_step``
  against ``repro.models.layers`` at 1e-5, from a carried state and conv
  state, at T up to 1000, past the ~800 positions where a single log-space
  cumulative sum of the decays would overflow fp32; the chunked scan
  ``rglru_scan`` against the exact recurrence in fp64.
* The mixed layer pattern: per-layer parameter and cache lists with the
  reference's leaves (the attention layers' cache linear, ``cache_size``
  positions, where the reference keeps a ring of one window).
* Reduced ``recurrentgemma_2b`` (window 64): a 100-token prompt in chunks of
  40 and 60, then decodes past the window, against the JAX ``TransformerLM``
  on its ring cache with a ``window_slack`` of the whole context, at 2e-3 on
  logits (``tests/test_models_smoke.py``'s tolerance).
* Real-mode serving of reduced ``recurrentgemma_2b`` against per-request
  greedy decoding with the JAX model, prompts past the window, ragged
  chunks, a mixed prefill+decode step and slots reused after release.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_reduced_config
from repro_torch.models import layers as TL
from repro_torch.models.convert import from_numpy
from repro_torch.models.transformer import build_model
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.serving.stack import build_stack

torch.set_num_threads(2)    # the suite runs in several workers at once

ARCH = "recurrentgemma_2b"
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
MAX_LEN = 192
# (prompt length, max_new_tokens): prompts past the reduced window of 64
WORKLOAD = [(100, 5), (37, 4), (70, 1), (81, 6)]
MARGIN = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def rglru_params():
    cfg = jax_reduced_config(ARCH)
    jp = JL.rglru_params(cfg, jax.random.key(0), jnp.float32)
    return cfg, jp, from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_causal_conv1d_matches_jax(rglru_params):
    cfg, jp, tp = rglru_params
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, cfg.rglru.lru_width)).astype(np.float32)
    state = rng.standard_normal((2, 3, cfg.rglru.lru_width)).astype(np.float32)
    for st in (None, state):
        jy, js = JL._causal_conv1d(jnp.asarray(x), jp["conv"],
                                   None if st is None else jnp.asarray(st))
        ty, ts = TL._causal_conv1d(_t(x), tp["conv"], None if st is None else _t(st))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **LAYER_TOL)


@pytest.mark.parametrize("T", [1, 7, 16, 45, 1000])
def test_rglru_matches_jax_from_a_carried_state(rglru_params, T):
    cfg, jp, tp = rglru_params
    W = cfg.rglru.lru_width
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, W)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.rglru.conv_width - 1, W)).astype(np.float32)
    fn_j, fn_t = (JL.rglru_step, TL.rglru_step) if T == 1 else (JL.rglru, TL.rglru)
    jy, jh, jc = jax.jit(fn_j, static_argnums=0)(cfg, jp, jnp.asarray(x), jnp.asarray(h0),
                                                 jnp.asarray(conv))
    ty, th, tc = fn_t(cfg, tp, _t(x), _t(h0), _t(conv))
    assert th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LAYER_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **LAYER_TOL)


def test_rglru_from_zero_state_matches_jax(rglru_params):
    cfg, jp, tp = rglru_params
    x = np.random.default_rng(3).standard_normal((1, 33, cfg.d_model)).astype(np.float32)
    jy, jh, _ = jax.jit(JL.rglru, static_argnums=0)(cfg, jp, jnp.asarray(x))
    ty, th, _ = TL.rglru(cfg, tp, _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LAYER_TOL)


@pytest.mark.parametrize("T,chunk", [(1000, 16), (37, 16), (5, 16), (300, 8), (300, 64)])
def test_rglru_scan_matches_the_exact_recurrence(T, chunk):
    """Decays as RecurrentGemma's at Λ = −4.3 (log a down to −0.108 a step):
    the chunked scan stays within fp32 rounding of the recurrence run in
    fp64, where exp(−cumsum) over T would have overflowed fp32."""
    g = torch.Generator().manual_seed(T + chunk)
    W = 24
    log_a = -0.108 * (0.85 + 0.15 * torch.rand((2, T, W), generator=g))
    b = torch.randn((2, T, W), generator=g)
    h0 = torch.randn((2, W), generator=g)
    if T == 1000:
        assert not torch.isfinite(torch.exp(-torch.cumsum(log_a, 1))).all()
    h = TL.rglru_scan(log_a, b, h0, chunk=chunk)
    a = torch.exp(log_a).double()
    state, exact = h0.double(), []
    for t in range(T):
        state = a[:, t] * state + b[:, t].double()
        exact.append(state)
    np.testing.assert_allclose(h.double().numpy(), torch.stack(exact, 1).numpy(),
                               **LAYER_TOL)


def test_mixed_pattern_params_and_cache_follow_the_reference():
    cfg = jax_reduced_config(ARCH)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(0), jnp.float32)
    jc = jm.init_cache(2, 128, jnp.float32)
    tm = build_model(get_reduced_config(ARCH))
    tp = tm.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    tc = tm.init_cache(2, 128, torch.bfloat16, "cpu")
    assert tm.uniform is None and tm.has_attn and tm.recurrent
    assert isinstance(tp["blocks"], list) and isinstance(tc["layers"], list)
    assert len(tp["blocks"]) == len(tc["layers"]) == cfg.num_layers
    for kind, jb, tb, jl, tl in zip(cfg.layer_pattern, jp["blocks"], tp["blocks"],
                                    jc["layers"], tc["layers"]):
        assert jax.tree.map(np.shape, jb) == {
            k: {n: tuple(t.shape) for n, t in v.items()} for k, v in tb.items()}
        assert set(jl) == set(tl)
        for name, leaf in tl.items():
            # a local-attention layer keeps the reference's ring of
            # min(cache_size, window) positions
            assert tuple(leaf.shape) == jl[name].shape
            if kind == "local_attn" and name != "kv_pos":
                assert leaf.shape[1] == cfg.sliding_window < 128
                assert leaf.dtype == torch.bfloat16
            elif kind == "local_attn":
                assert (leaf == -1).all()
            else:
                assert tuple(leaf.shape) == jl[name].shape and leaf.dtype == torch.float32
    assert sum(t.numel() for b in tp["blocks"] for v in b.values() for t in v.values()) \
        + tp["embed"].numel() + tp["final_norm"]["scale"].numel() == cfg.param_count()


def _models(seed):
    cfg = jax_reduced_config(ARCH)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(seed), jnp.float32)
    tm = build_model(get_reduced_config(ARCH))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def test_prefill_and_decode_past_the_window_match_jax():
    cfg, jm, jp, tm, tp = _models(0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 106))
    jc = jm.init_cache(2, MAX_LEN, jnp.float32, window_slack=MAX_LEN)
    tc = tm.init_cache(2, MAX_LEN, torch.float32, "cpu")
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    for a, b in ((0, 40), (40, 100)):
        jl, jc = prefill(jp, {"tokens": jnp.asarray(toks[:, a:b])}, jc)
        tl, tc = tm.prefill(tp, {"tokens": _t(toks[:, a:b])}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for t in range(100, 106):
        jl, jc = decode(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tm.decode_step(tp, tc, _t(toks[:, t:t + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc["cache_len"].tolist() == [106, 106]


def test_decode_slots_touches_only_its_rows():
    """A decode of rows 0 and 2 leaves row 1's RG-LRU state, conv state and
    attention cache as they were."""
    cfg, _, _, tm, tp = _models(1)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 21)))
    tc = tm.init_cache(3, 64, torch.float32, "cpu")
    tm.prefill(tp, {"tokens": toks[:, :20]}, tc)
    before = [{k: v.clone() for k, v in layer.items()} for layer in tc["layers"]]
    tm.decode_slots(tp, tc, toks[[0, 2], 20:21], torch.tensor([0, 2]))
    for b, a in zip(before, tc["layers"]):
        for k in a:
            assert torch.equal(a[k][1], b[k][1])
            assert not torch.equal(a[k][0], b[k][0])
    assert tc["cache_len"].tolist() == [21, 20, 21]


@pytest.fixture(scope="module")
def serving_setup():
    cfg, jm, jp, tm, tp = _models(13)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in WORKLOAD]
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    greedy = []
    for prompt, (_, max_new) in zip(prompts, WORKLOAD):
        cache = jm.init_cache(1, MAX_LEN, jnp.float32, window_slack=MAX_LEN)
        logits, cache = prefill(jp, {"tokens": jnp.asarray([prompt])}, cache)
        out = []
        while True:
            row = np.sort(np.asarray(logits[0]))
            assert row[-1] - row[-2] > MARGIN, "near-tie in the JAX stream"
            out.append(int(jnp.argmax(logits[0])))
            if len(out) == max_new:
                break
            logits, cache = decode(jp, cache, jnp.asarray([[out[-1]]]))
        greedy.append(out)
    return tm, tp, prompts, greedy


@pytest.mark.timeout(300)
@pytest.mark.parametrize("policy,max_seqs", [("vllm", 4), ("sglang", 4), ("vllm", 2)])
def test_real_engine_matches_greedy_jax(serving_setup, policy, max_seqs):
    tm, tp, prompts, greedy = serving_setup
    engine_cfg = EngineConfig(policy=policy, max_num_seqs=max_seqs, max_batched_tokens=48,
                              block_size=4, num_blocks=512, enable_prefix_caching=False,
                              chip="h100-sxm")
    stack = build_stack(get_reduced_config(ARCH), engine_cfg, "real", model=tm, params=tp,
                        max_len=MAX_LEN, device="cpu", dtype=torch.float32)
    reqs = [Request(prompt_tokens=p, max_new_tokens=n) for p, (_, n) in zip(prompts, WORKLOAD)]
    try:
        stack.engine.start()
        stack.engine.submit_many(reqs)
        assert stack.engine.wait_until_complete(len(reqs), timeout=240)
    finally:
        stack.shutdown()
    for req, expected in zip(reqs, greedy):
        assert req.output_tokens == expected, (req.prompt_len, req.output_tokens, expected)
    assert stack.runner.num_free_slots == max_seqs
    mixed = [s for s in stack.engine.step_log if s.num_prefill_tokens > 0 and s.num_decode > 0]
    assert bool(mixed) == (policy == "vllm")
