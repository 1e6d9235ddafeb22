"""The windowed layers' ring cache on the CPU, against the reference's.

A windowed attention layer (every layer of reduced ``mixtral_8x7b``, the
local-attention layers of reduced ``recurrentgemma_2b``; window 64) keeps a
ring of min(cache_size, window) + ``window_slack`` positions a row,
position p at p % S, as ``repro.models.transformer.block_cache`` does.

* The cache's leaves have the reference's shapes at several sizes and
  slacks, and a ring that is not a whole number of pages raises.
* Two rows of a 257-token prompt in chunks of 40, 130 and 87 (the second
  crosses the ring's end, the third wraps it), then 40 decodes, inline and
  with ``kv_append="defer"``:
  - at the reference runner's slack (512), where the reference's ring loses
    no key, the logits lie within 2e-3 of the JAX model's on its ring of the
    same slack at every step, and the K/V and position leaves equal the
    reference's wherever its tag is set (K/V at 2e-3, tags exactly);
  - at slack 0, where the reference's ring loses the keys a chunk longer
    than its slack overwrites, the port is held against itself at slack
    512, whose 576 positions never wrap (a linear cache): logits at 2e-4 at
    every step (and so within 2e-3 of the JAX model's), the tags those of
    a ring written in order, and each kept position's K/V that of the
    linear cache at that position (2e-4).
* A prefix-cache hit on reduced mixtral, whose blocks were saved as each
  prefill piece wrote them and are copied into the ring's rows, gives the
  tokens of the same run with caching off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_reduced_config
from repro_torch.models.convert import from_numpy
from repro_torch.models.transformer import build_model
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.serving.stack import build_stack

torch.set_num_threads(2)    # the suite runs in several workers at once

ARCHS = ["mixtral_8x7b", "recurrentgemma_2b"]
REF_SLACK = 512            # the reference runner's: its largest chunk bucket
CHUNKS = [40, 130, 87]     # a 257-token prompt
DECODES = 40
CACHE = 304                # positions up to 296, a multiple of 16
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
SELF_TOL = dict(rtol=2e-4, atol=2e-4)


def _attn_layers(cfg, cache):
    """[(k, v, kv_pos)] of every attention layer, (B, S, ...) each."""
    layers = cache["layers"]
    if isinstance(layers, dict):
        return [(layers["k"][i], layers["v"][i], layers["kv_pos"][i])
                for i in range(layers["k"].shape[0])]
    return [(c["k"], c["v"], c["kv_pos"]) for kind, c in zip(cfg.layer_pattern, layers)
            if kind in ("attn", "local_attn")]


def _numpy(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, dtype=np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch, JAX model and params, port model and params, tokens, the JAX
    logits and cache at the reference runner's slack)."""
    name = request.param
    cfg = jax_reduced_config(name)
    assert cfg.sliding_window == 64
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(31), jnp.float32)
    rng = np.random.default_rng(31)
    prompt = rng.integers(0, cfg.vocab_size, (2, sum(CHUNKS)))
    fed = rng.integers(0, cfg.vocab_size, (DECODES, 2, 1))
    jc = jm.init_cache(2, CACHE, jnp.float32, window_slack=REF_SLACK)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jlogits = []
    a = 0
    for n in CHUNKS:
        logits, jc = prefill(jp, {"tokens": jnp.asarray(prompt[:, a:a + n])}, jc)
        jlogits.append(np.asarray(logits))
        a += n
    for t in range(DECODES):
        logits, jc = decode(jp, jc, jnp.asarray(fed[t]))
        jlogits.append(np.asarray(logits))
    tm = build_model(get_reduced_config(name))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return name, cfg, (jm, jp), (tm, tp), (prompt, fed), (jlogits, jc)


def _port_run(tm, tp, toks, slack, mode):
    model = build_model(tm.cfg.replace(kv_append=mode))
    prompt, fed = toks
    cache = model.init_cache(2, CACHE, torch.float32, "cpu", window_slack=slack)
    out = []
    a = 0
    with torch.no_grad():
        for n in CHUNKS:
            logits, cache = model.prefill(tp, {"tokens": torch.from_numpy(prompt[:, a:a + n])},
                                          cache)
            out.append(logits.numpy())
            a += n
        for t in range(DECODES):
            logits, cache = model.decode_step(tp, cache, torch.from_numpy(fed[t]))
            out.append(logits.numpy())
    return out, cache


@pytest.mark.parametrize("mode", ["inline", "defer"])
def test_ring_at_the_reference_slack_matches_jax(arch, mode):
    _, cfg, _, (tm, tp), toks, (jlogits, jc) = arch
    got, cache = _port_run(tm, tp, toks, REF_SLACK, mode)
    for i, (g, e) in enumerate(zip(got, jlogits)):
        np.testing.assert_allclose(g, e, **LOGIT_TOL, err_msg=f"step {i}")
    ours, theirs = _attn_layers(cfg, cache), _attn_layers(cfg, jc)
    assert len(ours) == len(theirs) > 0
    for (k, v, pos), (jk, jv, jpos) in zip(ours, theirs):
        assert tuple(k.shape) == jk.shape and tuple(pos.shape) == jpos.shape
        live = np.asarray(jpos) >= 0
        assert live.sum() == 2 * (sum(CHUNKS) + DECODES)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_allclose(_numpy(k)[live], np.asarray(jk)[live], **LOGIT_TOL)
        np.testing.assert_allclose(_numpy(v)[live], np.asarray(jv)[live], **LOGIT_TOL)


@pytest.mark.parametrize("mode", ["inline", "defer"])
def test_ring_without_slack_matches_the_linear_cache(arch, mode):
    _, cfg, (jm, _), (tm, tp), toks, (jlogits, _) = arch
    got, ring = _port_run(tm, tp, toks, 0, mode)
    linear_logits, linear = _port_run(tm, tp, toks, REF_SLACK, mode)
    for i, (g, lin, e) in enumerate(zip(got, linear_logits, jlogits)):
        np.testing.assert_allclose(g, lin, **SELF_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(g, e, **LOGIT_TOL, err_msg=f"step {i}")
    jring = jm.init_cache(2, CACHE, jnp.float32)         # the reference's ring, slack 0
    end = sum(CHUNKS) + DECODES
    for (k, v, pos), (lk, lv, lpos), (jk, _, jpos) in zip(
            _attn_layers(cfg, ring), _attn_layers(cfg, linear), _attn_layers(cfg, jring)):
        S = k.shape[1]
        assert tuple(k.shape) == jk.shape and tuple(pos.shape) == jpos.shape and S == 64
        # slot i holds the newest position congruent to i
        newest = np.arange(S) + (end - 1 - np.arange(S)) // S * S
        np.testing.assert_array_equal(pos.numpy(), np.broadcast_to(newest, (2, S)))
        np.testing.assert_allclose(k.numpy(), lk[:, newest].numpy(), **SELF_TOL)
        np.testing.assert_allclose(v.numpy(), lv[:, newest].numpy(), **SELF_TOL)
        assert (lpos[:, newest] == pos).all()


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("cache_size,slack", [(CACHE, 0), (CACHE, REF_SLACK), (48, 0), (48, 16)])
def test_cache_shapes_are_the_references(name, cache_size, slack):
    jm = jax_build_model(jax_reduced_config(name))
    tm = build_model(get_reduced_config(name))
    jc = jm.init_cache(3, cache_size, jnp.float32, window_slack=slack)
    tc = tm.init_cache(3, cache_size, torch.float32, "cpu", slack)
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]

    def port_leaf(path):
        node = tc
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        return node
    for path, leaf in flat:
        assert tuple(port_leaf(path).shape) == leaf.shape, jax.tree_util.keystr(path)


@pytest.mark.parametrize("name", ARCHS)
def test_a_ring_off_the_page_grid_raises(name):
    tm = build_model(get_reduced_config(name))
    with pytest.raises(ValueError, match="multiple of the page size"):
        tm.init_cache(1, CACHE, torch.float32, "cpu", window_slack=8)


def test_a_local_layer_without_a_window_keeps_the_whole_row():
    """recurrentgemma without its window (the reference cannot build it):
    its local-attention layers keep ``cache_size`` positions, no ring."""
    tm = build_model(get_reduced_config("recurrentgemma_2b").replace(sliding_window=None))
    cache = tm.init_cache(1, 96, torch.float32, "cpu")
    spans = [c["k"].shape[1] for kind, c in zip(tm.cfg.layer_pattern, cache["layers"])
             if kind == "local_attn"]
    assert spans == [96] and not tm.windowed


def _stack(model, params, caching, block_size):
    engine_cfg = EngineConfig(policy="vllm", max_num_seqs=4, max_batched_tokens=100,
                              block_size=block_size, num_blocks=256 * 16 // block_size,
                              enable_prefix_caching=caching, chip="h100-sxm")
    return build_stack(model.cfg, engine_cfg, "real", model=model, params=params,
                       max_len=CACHE, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("block_size", [16, 4])
def test_windowed_prefix_hits_give_the_unhit_tokens(block_size):
    """Reduced mixtral, four requests sharing a 150-token prefix (9 full
    blocks of 16, 37 of 4; more than twice the ring): the first alone, the
    rest after it, their prompts in chunks of up to 100 tokens, each cut in
    pieces of 64 - block_size (48 or 60) where the store is on.  The hits
    load the blocks of the window before each request's start into its
    ring.  Blocks of 4 are the engine's of the fig6 accuracy run."""
    cfg = get_reduced_config("mixtral_8x7b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(32), torch.float32, "cpu")
    rng = np.random.default_rng(32)
    prefix = rng.integers(0, cfg.vocab_size, 150).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size, n).tolist() for n in (7, 30, 61, 12)]
    runs = {}
    for caching in (False, True):
        stack = _stack(model, params, caching, block_size)
        reqs = [Request(prompt_tokens=list(p), max_new_tokens=6) for p in prompts]
        engine = stack.engine
        for wave in (reqs[:1], reqs[1:]):
            for r in wave:
                engine.scheduler.add_request(r)
            while not all(r.finished for r in wave):
                engine.step()
        runs[caching] = (stack, reqs)
    stack, hit = runs[True]
    assert stack.runner._ring == (64, 64)
    assert stack.engine.prefix_cache.stats.device_hits > 0
    assert [r.cached_prefix_len for r in hit[1:]] == [150 // block_size * block_size] * 3
    for a, b in zip(hit, runs[False][1]):
        assert a.output_tokens == b.output_tokens
