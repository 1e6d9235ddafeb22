"""Whisper's encoder-decoder in the port against the JAX package on the CPU.

* ``layers.full_mask`` against the reference's.
* ``EncDecLM.encode`` (bidirectional self-attention through ``ops.
  flash_attention(causal=False)``) and ``_cross_kv`` against the JAX
  ``EncDecLM``'s at 1e-5 in fp32.
* Reduced ``whisper_base``: a prefill with frame embeddings (the encoder,
  then the decoder over 20 tokens in chunks of 12 and 8), then decodes
  (cross-attention through ``ops.paged_attention`` over the slot's padded
  cross cache, F keys each), against the JAX model at 2e-3 on logits; also
  with fewer frames than a whole number of pages.
* The parameters carried from JAX keep the reference's tree and the
  config's count, as does the port's own init.
* Real-mode serving (no frames, as in the reference's runner, so the
  decoder cross-attends over a zero cache) against per-request greedy
  decoding with the JAX model, slots reused after release.
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
from repro_torch.models.transformer import EncDecLM, build_model
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.serving.stack import build_stack

torch.set_num_threads(2)    # the suite runs in several workers at once

ARCH = "whisper_base"
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
MAX_LEN = 64
WORKLOAD = [(24, 5), (37, 4), (9, 1), (29, 6)]
MARGIN = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    cfg = jax_reduced_config(ARCH)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(5), jnp.float32)
    tm = build_model(get_reduced_config(ARCH))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _frames(cfg, B, F, seed):
    fe = np.random.default_rng(seed).standard_normal((B, F, cfg.d_model))
    return fe.astype(np.float32)


def test_full_mask_matches_jax():
    q_pos = np.array([[0, 1, 2], [5, 6, 7]], np.int32)
    kv_pos = np.array([[0, 1, -1, 3, 4], [-1, -1, 2, 3, 9]], np.int32)
    exp = np.asarray(JL.full_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos)))
    got = TL.full_mask(_t(q_pos), _t(kv_pos))
    assert got.shape == exp.shape and np.array_equal(got.numpy(), exp)


def test_encode_and_cross_kv_match_jax(models):
    cfg, jm, jp, tm, tp = models
    fe = _frames(cfg, 2, cfg.encoder.max_source_positions, 0)
    j_enc = jm.encode(jp, jnp.asarray(fe))
    t_enc = tm.encode(tp, _t(fe))
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), **LAYER_TOL)
    jk, jv = jm._cross_kv(jp, j_enc)
    tk, tv = tm._cross_kv(tp, _t(np.asarray(j_enc)))
    assert tuple(tk.shape) == jk.shape == (cfg.num_layers, 2, fe.shape[1],
                                           cfg.num_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **LAYER_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **LAYER_TOL)


@pytest.mark.parametrize("frames", [32, 20])
def test_prefill_with_frames_then_decode_matches_jax(models, frames):
    """20 frames fill 1.25 of K2's 16-position pages: the cross cache is
    padded to 32 and the decodes read 20 keys of it."""
    cfg, jm, jp, tm, tp = models
    fe = _frames(cfg, 2, frames, 1)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 25))
    jc = jm.init_cache(2, MAX_LEN, jnp.float32, enc_frames=frames)
    tc = tm.init_cache(2, MAX_LEN, torch.float32, "cpu", enc_frames=frames)
    assert tuple(tc["cross_k"].shape) == (cfg.num_layers, 2, 32, cfg.num_kv_heads,
                                          cfg.head_dim)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :12]),
                             "frontend_embeds": jnp.asarray(fe)}, jc)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks[:, :12]), "frontend_embeds": _t(fe)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc["cross_k"][:, :, :frames].numpy(), np.asarray(jc["cross_k"]),
                               **LAYER_TOL)
    assert not tc["cross_k"][:, :, frames:].any()
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, 12:20])}, jc)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks[:, 12:20])}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for t in range(20, 25):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tm.decode_step(tp, tc, _t(toks[:, t:t + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc["cache_len"].tolist() == [25, 25]


def test_frames_must_fill_the_cache(models):
    cfg, _, _, tm, tp = models
    tc = tm.init_cache(1, MAX_LEN, torch.float32, "cpu")
    with pytest.raises(ValueError, match="frames"):
        tm.prefill(tp, {"tokens": torch.zeros((1, 4), dtype=torch.long),
                        "frontend_embeds": _t(_frames(cfg, 1, 7, 2))}, tc)


def test_carried_and_initialised_params_follow_the_reference(models):
    cfg, _, jp, _, tp = models
    shapes = jax.tree.map(np.shape, jp)

    def torch_shapes(tree):
        if isinstance(tree, dict):
            return {k: torch_shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert torch_shapes(tp) == shapes
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    own = EncDecLM(get_reduced_config(ARCH)).init(torch.Generator().manual_seed(0),
                                                 torch.float32, "cpu")
    assert torch_shapes(own) == shapes
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple)))
    assert n == cfg.param_count()


@pytest.fixture(scope="module")
def greedy(models):
    cfg, jm, jp, _, _ = models
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in WORKLOAD]
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    out_all = []
    for prompt, (_, max_new) in zip(prompts, WORKLOAD):
        cache = jm.init_cache(1, MAX_LEN, jnp.float32)
        logits, cache = prefill(jp, {"tokens": jnp.asarray([prompt])}, cache)
        out = []
        while True:
            row = np.sort(np.asarray(logits[0]))
            assert row[-1] - row[-2] > MARGIN, "near-tie in the JAX stream"
            out.append(int(jnp.argmax(logits[0])))
            if len(out) == max_new:
                break
            logits, cache = decode(jp, cache, jnp.asarray([[out[-1]]]))
        out_all.append(out)
    return prompts, out_all


@pytest.mark.timeout(300)
@pytest.mark.parametrize("policy,max_seqs", [("vllm", 4), ("sglang", 2)])
def test_real_engine_matches_greedy_jax(models, greedy, policy, max_seqs):
    _, _, _, tm, tp = models
    prompts, expected = greedy
    engine_cfg = EngineConfig(policy=policy, max_num_seqs=max_seqs, max_batched_tokens=16,
                              block_size=4, num_blocks=256, enable_prefix_caching=False,
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
    for req, exp in zip(reqs, expected):
        assert req.output_tokens == exp, (req.prompt_len, req.output_tokens, exp)
    assert stack.runner.num_free_slots == max_seqs
    assert not stack.runner.cache["cross_k"].any()


def test_reset_slot_zeroes_the_cross_cache(models):
    """A slot's cross K/V (written by a prefill with frames) goes back to
    zeros when the slot is reset for a new request; other slots keep theirs."""
    cfg, _, _, tm, tp = models
    stack = build_stack(get_reduced_config(ARCH), EngineConfig(max_num_seqs=2, chip="h100-sxm",
                                                                enable_prefix_caching=False),
                        "real", model=tm, params=tp, max_len=MAX_LEN, device="cpu",
                        dtype=torch.float32)
    runner = stack.runner
    fe = _t(_frames(cfg, 1, cfg.encoder.max_source_positions, 3))
    for slot in (0, 1):
        tm.prefill(tp, {"tokens": torch.zeros((1, 3), dtype=torch.long),
                        "frontend_embeds": fe}, runner._slot_view(slot))
    assert runner.cache["cross_k"][:, 0].any() and runner.cache["cross_v"][:, 1].any()
    runner._reset_slot(0)
    assert not runner.cache["cross_k"][:, 0].any() and not runner.cache["cross_v"][:, 0].any()
    assert runner.cache["cross_k"][:, 1].any()
    assert (runner.cache["layers"]["kv_pos"][:, 0] == -1).all()
    stack.shutdown()
