"""Real-mode prefix-cache hits (the reference runner's fault F4) on the CPU.

With prefix caching on, the port's runner keeps the KV of the blocks that
the prefix cache holds and copies a hit's blocks into the new slot, so the
prefill goes on from ``cached_prefix_len``.  On reduced ``llama3_8b`` in
fp32:

* requests that share a 30-token prefix with one that finished before they
  arrived are served with hits (``stats.device_hits > 0``), and every
  request's tokens equal those of the same run with caching off and of
  per-request greedy decoding with the JAX model;
* a hit whose blocks' owner finished and whose slot was then reused by an
  unrelated request still reads the owner's KV (one slot for all);
* a block the prefix cache holds is never handed to another request before
  it is evicted, and its KV in the store stays as the owner left it;
* a hit on reduced ``recurrentgemma_2b``, whose RG-LRU state the prefix
  cache does not hold, raises naming ROADMAP item F4.
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

ARCH = "llama3_8b"
MAX_LEN = 128
BLOCK = 4
PREFIX = 30                  # 7 full blocks of 4 are shared
SUFFIXES = [(9, 5), (14, 4), (3, 6), (22, 3)]   # (suffix length, max_new_tokens)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = jax_reduced_config(ARCH)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(21), jnp.float32)
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in SUFFIXES]
    unrelated = rng.integers(0, cfg.vocab_size, 40).tolist()
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    greedy = []
    for prompt, (_, max_new) in zip(prompts, SUFFIXES):
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
        greedy.append(out)
    model = build_model(get_reduced_config(ARCH))
    params = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return model, params, prompts, unrelated, greedy


def _stack(model, params, caching, max_seqs=4, num_blocks=512, arch=ARCH):
    engine_cfg = EngineConfig(policy="vllm", max_num_seqs=max_seqs, max_batched_tokens=48,
                              block_size=BLOCK, num_blocks=num_blocks,
                              enable_prefix_caching=caching, chip="h100-sxm")
    return build_stack(get_reduced_config(arch), engine_cfg, "real", model=model,
                       params=params, max_len=MAX_LEN, device="cpu", dtype=torch.float32)


def _serve(stack, waves, check=None):
    """Serve each wave of requests to completion, in the calling thread, one
    wave after the other; ``check(engine)`` runs after every step."""
    engine = stack.engine
    for wave in waves:
        for r in wave:
            engine.scheduler.add_request(r)
        while not all(r.finished for r in wave):
            engine.step()
            if check is not None:
                check(engine)


def _requests(prompts):
    return [Request(prompt_tokens=list(p), max_new_tokens=n)
            for p, (_, n) in zip(prompts, SUFFIXES)]


@pytest.mark.timeout(300)
def test_hits_are_served_and_match_the_uncached_run(setup):
    model, params, prompts, _, greedy = setup
    runs = {}
    for caching in (False, True):
        stack = _stack(model, params, caching)
        reqs = _requests(prompts)
        _serve(stack, [reqs[:1], reqs[1:]])       # the first finishes before the rest arrive
        runs[caching] = (stack, reqs)
    stack, cached = runs[True]
    stats = stack.engine.prefix_cache.stats
    assert stats.device_hits > 0 and stats.hit_tokens >= 3 * (PREFIX // BLOCK) * BLOCK
    assert [r.cached_prefix_len for r in cached[1:]] == [(PREFIX // BLOCK) * BLOCK] * 3
    assert stack.engine.stats()["prefix_hit_rate"] > 0
    assert runs[False][0].engine.prefix_cache.stats.hit_tokens == 0
    for hit, plain, expected in zip(cached, runs[False][1], greedy):
        assert hit.output_tokens == plain.output_tokens == expected
    # a hit's prefill skipped the cached positions
    prefill_tokens = sum(s.num_prefill_tokens for s in stack.engine.step_log)
    assert prefill_tokens == sum(len(p) for p in prompts) - 3 * 28
    assert stack.runner.num_free_slots == 4


@pytest.mark.timeout(300)
def test_hit_after_the_owner_slot_was_reused(setup):
    """One slot: the owner of the prefix finishes, an unrelated request takes
    its slot and overwrites its KV, and then a request with the prefix hits:
    its blocks' KV comes from the store, not from the slot."""
    model, params, prompts, unrelated, greedy = setup
    stack = _stack(model, params, True, max_seqs=1)
    owner, other, hit = _requests([prompts[0], unrelated, prompts[1]])
    other.max_new_tokens = 3
    hit.max_new_tokens = SUFFIXES[1][1]
    _serve(stack, [[owner], [other], [hit]])
    assert hit.cached_prefix_len == (PREFIX // BLOCK) * BLOCK
    assert owner.output_tokens == greedy[0]
    assert hit.output_tokens == greedy[1]


@pytest.mark.timeout(300)
def test_cached_blocks_are_not_retaken_before_eviction(setup):
    """After the owner finishes, its cached blocks are pinned: no request
    that does not hit them gets them, and their KV in the store stays as
    the owner left it, while a pool of 35 blocks cycles through unrelated
    requests, short enough that the last of them evicts a few of the
    owner's blocks (LRU leaves first) and no more."""
    model, params, prompts, unrelated, _ = setup
    stack = _stack(model, params, True, max_seqs=2, num_blocks=35)
    engine, runner = stack.engine, stack.runner
    owner = _requests(prompts[:1])[0]
    _serve(stack, [[owner]])
    cache = engine.prefix_cache
    held = dict(cache._nodes_by_block)               # block id -> the owner's node
    assert held and not set(held) & engine.bm._free
    ids = sorted(held)
    kept = {k: runner._store[k][:, ids].clone() for k in ("k", "v")}
    rng = np.random.default_rng(4)
    others = [Request(prompt_tokens=rng.integers(0, 512, n).tolist(), max_new_tokens=4)
              for n in (23, 31, 17, 26, 10)]
    evicted = set()

    def still_held():
        return {b for b, node in held.items() if cache._nodes_by_block.get(b) is node}

    def check(eng):
        still = still_held()
        evicted.update(set(held) - still)
        for r in eng.scheduler.running:
            assert not set(eng.bm.block_tables[r.request_id]) & still

    _serve(stack, [others], check)
    still = sorted(still_held())
    assert still and evicted, "the pool never ran short, or every cached block went"
    pos = [ids.index(b) for b in still]
    for k in ("k", "v"):
        assert torch.equal(runner._store[k][:, still], kept[k][:, pos])


def test_a_hit_on_a_recurrent_model_raises_naming_f4():
    """Reduced ``recurrentgemma_2b``: its RG-LRU layers' state is not in the
    prefix cache, so the runner keeps no store and a hit raises
    (``tests/test_torch_serving.py`` has the SSD case)."""
    cfg = get_reduced_config("recurrentgemma_2b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    stack = _stack(model, params, True, arch="recurrentgemma_2b")
    assert stack.runner._store is None
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 24).tolist()
    engine = stack.engine
    first = Request(prompt_tokens=prompt[:16], max_new_tokens=2)
    engine.scheduler.add_request(first)
    while not first.finished:
        engine.step()
    engine.scheduler.add_request(Request(prompt_tokens=prompt, max_new_tokens=2))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item F4"):
        engine.step()
