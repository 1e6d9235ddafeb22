"""The port's attention decoders against the JAX model on the CPU, in fp32.

Reduced ``llama3_8b``, ``qwen2_5_3b`` (qkv bias, tied embeddings),
``granite_8b``, ``granite_3_8b`` (tied embeddings), ``olmo_1b``
(non-parametric LayerNorm, tied embeddings, MHA), ``llama3_70b``,
``mixtral_8x7b`` (dropless MoE, sliding window), ``qwen3_30b_a3b`` (MoE),
``dbrx_132b`` (MoE with LayerNorm) and ``llava_next_mistral_7b`` (frontend
embeddings prepended to the first chunk): the JAX parameters are carried
into the port by ``repro_torch.models.convert``, inputs are made with numpy
from a seed, and the outputs are compared at the reference's own tolerances
(``tests/test_models_smoke.py``: 2e-3 on logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import (ARCH_IDS, PAPER_ARCH_IDS, get_config,
                                 get_reduced_config)
from repro_torch.models import layers as TL
from repro_torch.models.convert import from_numpy
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)    # the suite runs in several workers at once

ARCHS = ["llama3_8b", "qwen2_5_3b", "granite_8b", "granite_3_8b", "olmo_1b",
         "llama3_70b", "mixtral_8x7b", "qwen3_30b_a3b", "dbrx_132b",
         "llava_next_mistral_7b"]
ALL_ARCHS = sorted(ARCH_IDS + PAPER_ARCH_IDS)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)


def _models(arch, seed):
    cfg = jax_reduced_config(arch)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(seed), jnp.float32)
    tm = build_model(get_reduced_config(arch))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(cfg, toks, seed):
    """JAX and port inputs for a prefill of ``toks``; a frontend config's
    also carry frontend embeddings (B, F, d) made from ``seed``."""
    j, t = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if cfg.frontend is not None:
        rng = np.random.default_rng(seed)
        fe = 0.02 * rng.standard_normal((toks.shape[0], cfg.frontend_tokens, cfg.d_model))
        j["frontend_embeds"] = jnp.asarray(fe.astype(np.float32))
        t["frontend_embeds"] = _t(fe.astype(np.float32))
    return j, t


def test_configs_are_the_reference_configs():
    from dataclasses import asdict

    from repro.configs import get_config as jax_get_config
    assert len(ALL_ARCHS) == 13
    for arch in ALL_ARCHS:
        assert asdict(get_config(arch)) == asdict(jax_get_config(arch))
        assert asdict(get_reduced_config(arch)) == asdict(jax_reduced_config(arch))


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "whisper_base"])
def test_unported_config_names_its_roadmap_item(arch):
    """The two configs that raised until RG-LRU and the encoder-decoder were
    ported now build, at full size and reduced, the reduced one with the
    config's parameter count (``chip_smoke.py`` counts the full ones on the
    card).  The deferred KV append (ROADMAP item 9) builds too: RecurrentGemma
    keeps it (``tests/test_torch_kv_defer.py`` holds it to the JAX model);
    Whisper keeps the inline append, as the reference's ``EncDecLM`` does."""
    assert build_model(get_config(arch)).cfg.arch_id == arch
    cfg = get_reduced_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert sum(t.numel() for t in _leaves(params)) == cfg.param_count()
    deferred = get_reduced_config(arch).replace(kv_append="defer")
    expected = "inline" if arch == "whisper_base" else "defer"
    assert build_model(deferred).cfg.kv_append == expected


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_builds_or_names_its_roadmap_item(arch):
    """The reduced model of each of the 13 architectures builds with the
    config's parameter count; none raises naming a ROADMAP item any more."""
    cfg = get_reduced_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert sum(t.numel() for t in _leaves(params)) == cfg.param_count()


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ARCHS)
def test_layers_match_jax(arch):
    cfg, _, jp, _, tp = _models(arch, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(3, 10, dtype=np.int32), (2, 1))
    jb = jax.tree.map(lambda a: a[0], jp["blocks"])
    tb = {k: {n: t[0] for n, t in v.items()} for k, v in tp["blocks"].items()}

    np.testing.assert_allclose(
        TL.apply_norm(cfg, _t(x), tb["norm1"]).numpy(),
        np.asarray(JL.apply_norm(cfg, jnp.asarray(x), jb["norm1"])), **LAYER_TOL)
    heads = rng.standard_normal((2, 7, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rope(_t(heads), _t(pos), cfg.rope_theta).numpy(),
        np.asarray(JL.rope(jnp.asarray(heads), jnp.asarray(pos), cfg.rope_theta)),
        **LAYER_TOL)
    for t_out, j_out in zip(TL.attn_qkv(cfg, tb["attn"], _t(x), _t(pos)),
                            JL.attn_qkv(cfg, jb["attn"], jnp.asarray(x), jnp.asarray(pos))):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **LAYER_TOL)
    if cfg.moe is not None:
        t_y, t_aux = TL.moe(cfg, tb["moe"], _t(x))
        j_y, j_aux = JL.moe(cfg, jb["moe"], jnp.asarray(x))
        np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), **LAYER_TOL)
        for key in ("moe_aux_loss", "expert_load"):
            np.testing.assert_allclose(t_aux[key].numpy(), np.asarray(j_aux[key]), **LAYER_TOL)
    else:
        np.testing.assert_allclose(
            TL.mlp(cfg, tb["mlp"], _t(x)).numpy(),
            np.asarray(JL.mlp(cfg, jb["mlp"], jnp.asarray(x))), **LAYER_TOL)
    # the dense reference attention and its mask, kept for layer parity
    q, k, v = (rng.standard_normal((2, 7, h, cfg.head_dim)).astype(np.float32)
               for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    kv_pos = pos.copy()
    kv_pos[1, -2:] = -1
    jmask = JL.causal_mask(jnp.asarray(pos), jnp.asarray(kv_pos))
    tmask = TL.causal_mask(_t(pos), _t(kv_pos))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(
        TL.attention(_t(q), _t(k), _t(v), tmask).numpy(),
        np.asarray(JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask)),
        **LAYER_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_jax(arch):
    """prefill(T) then decode against the JAX model, and against the port's
    own prefill(T + 1); a frontend's F embeddings come first, so the cache
    holds F + T + 1 positions."""
    cfg, jm, jp, tm, tp = _models(arch, 3)
    B, T = 2, 12
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T + 1))
    j_in, t_in = _inputs(cfg, toks[:, :T], 3)
    n = T + 1 + cfg.frontend_tokens

    jc = jm.init_cache(B, 64, jnp.float32)
    jl_pre, jc = jm.prefill(jp, j_in, jc)
    jl_dec, _ = jm.decode_step(jp, jc, jnp.asarray(toks[:, T:]))

    tc = tm.init_cache(B, 64, torch.float32, "cpu")
    tl_pre, tc = tm.prefill(tp, t_in, tc)
    tl_dec, tc = tm.decode_step(tp, tc, _t(toks[:, T:]))
    assert tc["cache_len"].tolist() == [n] * B
    assert tc["layers"]["kv_pos"][:, :, :n].tolist() == (
        [[list(range(n))] * B] * cfg.num_layers)
    assert (tc["layers"]["kv_pos"][:, :, n:] == -1).all()

    np.testing.assert_allclose(tl_pre.numpy(), np.asarray(jl_pre), **LOGIT_TOL)
    np.testing.assert_allclose(tl_dec.numpy(), np.asarray(jl_dec), **LOGIT_TOL)
    _, t_full = _inputs(cfg, toks, 3)
    full, _ = tm.prefill(tp, t_full, tm.init_cache(B, 64, torch.float32, "cpu"))
    np.testing.assert_allclose(full.numpy(), tl_dec.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("split", [8, 15])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_matches_jax(arch, split):
    """Two prefill chunks equal the JAX model's monolithic prefill; a last
    chunk of one token takes the paged (decode) path.  Frontend embeddings
    arrive with the first chunk only."""
    cfg, jm, jp, tm, tp = _models(arch, 4)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 16))
    j_in, _ = _inputs(cfg, toks, 4)
    jl, _ = jm.prefill(jp, j_in, jm.init_cache(1, 64, jnp.float32))
    tc = tm.init_cache(1, 64, torch.float32, "cpu")
    _, t_first = _inputs(cfg, toks[:, :split], 4)
    _, tc = tm.prefill(tp, t_first, tc)
    tl, _ = tm.prefill(tp, {"tokens": _t(toks[:, split:])}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_slots_touches_only_its_slots(arch):
    """Decoding rows [2, 0] gives the logits of those rows decoded on their
    own and leaves row 1 (mid-prefill) bit for bit as it was."""
    cfg, jm, jp, tm, tp = _models(arch, 5)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 10))
    nxt = rng.integers(0, cfg.vocab_size, (3, 1))
    j_in, t_in = _inputs(cfg, toks, 5)
    n = 10 + cfg.frontend_tokens
    cache = tm.init_cache(3, 32, torch.float32, "cpu")
    _, cache = tm.prefill(tp, t_in, cache)
    before = {k: v[:, 1].clone() for k, v in cache["layers"].items()}
    logits = tm.decode_slots(tp, cache, _t(nxt[[2, 0]]), torch.tensor([2, 0]))
    for k, v in cache["layers"].items():
        assert torch.equal(v[:, 1], before[k]), k
    assert cache["cache_len"].tolist() == [n + 1, n, n + 1]
    for i, row in enumerate((2, 0)):
        jc = jm.init_cache(1, 32, jnp.float32)
        _, jc = jm.prefill(jp, {k: v[row:row + 1] for k, v in j_in.items()}, jc)
        jl, _ = jm.decode_step(jp, jc, jnp.asarray(nxt[row:row + 1]))
        np.testing.assert_allclose(logits[i:i + 1].numpy(), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_accounting(arch):
    cfg = get_reduced_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    _, _, _, _, converted = _models(arch, 0)

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return tree.numel()

    assert count(params) == cfg.param_count()
    assert count(converted) == cfg.param_count()


def test_unported_paths_raise():
    """Unknown values raise; ``moe_impl="a2a"`` builds, and without a mesh
    runs the dropless MoE (the reference's fallback)."""
    cfg = get_reduced_config("llama3_8b")
    moe_cfg = get_reduced_config("mixtral_8x7b")
    a2a, ragged = build_model(moe_cfg.replace(moe_impl="a2a")), build_model(moe_cfg)
    params = ragged.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    tokens = torch.randint(0, moe_cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    logits = [m.prefill(params, {"tokens": tokens}, m.init_cache(2, 16, torch.float32, "cpu"))[0]
              for m in (a2a, ragged)]
    assert torch.equal(logits[0], logits[1])
    with pytest.raises(ValueError, match="kv_append"):
        build_model(cfg.replace(kv_append="later"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    cache = model.init_cache(2, 32, torch.float32, "cpu")
    cache["cache_len"][1] = 3
    with pytest.raises(ValueError, match="one cache_len"):
        model.prefill(params, {"tokens": torch.zeros(2, 4, dtype=torch.long)}, cache)
    with pytest.raises(ValueError, match="multiple of the page size"):
        model.init_cache(1, 20, torch.float32, "cpu")


def test_cuda_default_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    model = build_model(get_reduced_config("llama3_8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init()
