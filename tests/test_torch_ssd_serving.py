"""The port's real-mode engine serving reduced ``mamba2_370m`` on the CPU,
against per-request greedy decoding with the JAX ``TransformerLM``.

The JAX model prefills a prompt in two calls, the largest multiple of the
chunk length and then the rest, because its ``ssd_prefill`` refuses a
longer T that is not a multiple of the chunk (fault F5 of the reference);
the recurrence is the same either way.  The engine's 48-token budget cuts
the prompts into ragged chunks that carry the slot's state from one to the
next; a mixed prefill+decode step (vllm policy) checks that a decode writes
only the decoding slots' states; and four requests over two slots check that
a slot reused after its release starts from a zeroed state.
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

ARCH = "mamba2_370m"
MAX_LEN = 128
# (prompt length, max_new_tokens): no prompt is a multiple of the chunk (16)
WORKLOAD = [(37, 5), (21, 4), (50, 1), (29, 6)]
MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = jax_reduced_config(ARCH)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(12), jnp.float32)
    # slow decays (A = -0.02 instead of -1..-16): a state left over in a
    # reused slot would then still move the stream many tokens later
    ssd = jp["blocks"]["ssd"]
    ssd["A_log"] = jnp.full_like(ssd["A_log"], np.log(0.02))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in WORKLOAD]
    chunk = cfg.ssm.chunk_size

    prefill = jax.jit(jm.prefill)
    decode = jax.jit(jm.decode_step)
    greedy = []
    for prompt, (n, max_new) in zip(prompts, WORKLOAD):
        cache = jm.init_cache(1, MAX_LEN, jnp.float32)
        head = n - n % chunk
        for part in (prompt[:head], prompt[head:]):
            logits, cache = prefill(jp, {"tokens": jnp.asarray([part])}, cache)
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
    return model, params, prompts, greedy


def _serve(model, params, prompts, max_seqs, policy="vllm"):
    engine_cfg = EngineConfig(policy=policy, max_num_seqs=max_seqs, max_batched_tokens=48,
                              block_size=4, num_blocks=512, enable_prefix_caching=False,
                              chip="h100-sxm")
    stack = build_stack(get_reduced_config(ARCH), engine_cfg, "real", model=model,
                        params=params, max_len=MAX_LEN, device="cpu", dtype=torch.float32)
    reqs = [Request(prompt_tokens=p, max_new_tokens=n) for p, (_, n) in zip(prompts, WORKLOAD)]
    try:
        stack.engine.start()
        stack.engine.submit_many(reqs)
        assert stack.engine.wait_until_complete(len(reqs), timeout=240)
    finally:
        stack.shutdown()
    return stack, reqs


@pytest.mark.timeout(300)
@pytest.mark.parametrize("policy", ["vllm", "sglang"])
def test_real_engine_matches_greedy_jax(setup, policy):
    model, params, prompts, greedy = setup
    stack, reqs = _serve(model, params, prompts, 4, policy)
    for req, expected in zip(reqs, greedy):
        assert req.output_tokens == expected, (req.prompt_len, req.output_tokens, expected)
    assert stack.runner.num_free_slots == 4
    chunks = [(s.new_tokens, s.context_len) for spec, _ in stack.runner.samples
              for s in spec.seqs if s.new_tokens > 1]
    # a ragged chunk ran, and a chunk went on from a slot's carried state
    assert any(n % 16 for n, _ in chunks) and any(ctx > n for n, ctx in chunks), chunks
    mixed = [s for s in stack.engine.step_log
             if s.num_prefill_tokens > 0 and s.num_decode > 0]
    assert bool(mixed) == (policy == "vllm")


@pytest.mark.timeout(300)
def test_reused_slot_starts_from_a_zero_state(setup):
    """Two slots for four requests: the last two run in slots released by the
    first two, and their streams still equal the JAX model's."""
    model, params, prompts, greedy = setup
    stack, reqs = _serve(model, params, prompts, 2)
    for req, expected in zip(reqs, greedy):
        assert req.output_tokens == expected, (req.prompt_len, req.output_tokens, expected)
    assert stack.runner.num_free_slots == 2
    layers = stack.runner.cache["layers"]
    before = {k: v.clone() for k, v in layers.items()}
    stack.runner._reset_slot(1)
    assert not layers["state"][:, 1].any() and not layers["conv"][:, 1].any()
    assert torch.equal(layers["state"][:, 0], before["state"][:, 0])
