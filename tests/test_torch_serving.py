"""The port's real-mode engine on the CPU against per-request greedy decoding
with the JAX ``TransformerLM``.

The reference runner (``repro.serving.model_runner.RealModelRunner``) is not
the yardstick: it returns a pad token's logits for a padded final chunk (F1),
decodes each token one position late (F2), and its batched decode writes
into slots that are not decoding (F3).  So the port's token streams are held
against the JAX *model*, one request at a time: a batch-1 prefill of the
prompt, then ``decode_step`` per token.  The workload has prompt lengths
that are not multiples of 32 (F1), several output tokens per request (F2), a
step in which one request's prefill runs beside others' decodes (F3, vllm
policy), and a request with ``max_new_tokens=1`` whose slot must come back.
A prefix-cache hit on an SSM must raise (F4); hits on attention models are
served (``tests/test_torch_prefix_serving.py``).
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
# (prompt length, max_new_tokens): no prompt is a multiple of 32
WORKLOAD = [(24, 5), (37, 4), (50, 1), (29, 6)]
MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = jax_reduced_config(ARCH)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(11), jnp.float32)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in WORKLOAD]

    prefill = jax.jit(jm.prefill)
    decode = jax.jit(jm.decode_step)
    greedy = []
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
        greedy.append(out)

    model = build_model(get_reduced_config(ARCH))
    params = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return model, params, prompts, greedy


def _engine_cfg(policy, prefix_caching=False):
    return EngineConfig(policy=policy, max_num_seqs=4, max_batched_tokens=48,
                        block_size=4, num_blocks=512,
                        enable_prefix_caching=prefix_caching, chip="h100-sxm")


@pytest.mark.timeout(300)
@pytest.mark.parametrize("policy", ["vllm", "sglang"])
def test_real_engine_matches_greedy_jax(setup, policy):
    model, params, prompts, greedy = setup
    stack = build_stack(get_reduced_config(ARCH), _engine_cfg(policy), "real",
                        model=model, params=params, max_len=MAX_LEN,
                        device="cpu", dtype=torch.float32)
    reqs = [Request(prompt_tokens=p, max_new_tokens=n)
            for p, (_, n) in zip(prompts, WORKLOAD)]
    try:
        stack.engine.start()
        stack.engine.submit_many(reqs)
        assert stack.engine.wait_until_complete(len(reqs), timeout=240)
    finally:
        stack.shutdown()

    for req, expected in zip(reqs, greedy):
        assert req.output_tokens == expected, (req.prompt_len, req.output_tokens, expected)
    assert stack.runner.num_free_slots == 4          # every slot came back
    mixed = [s for s in stack.engine.step_log
             if s.num_prefill_tokens > 0 and s.num_decode > 0]
    if policy == "vllm":
        assert mixed, "no step ran a prefill beside decodes"
    else:
        assert not mixed
    assert len(stack.runner.samples) == len(stack.engine.step_log)


def test_prefix_hit_raises():
    """A prefix-cache hit is served for an attention model
    (``tests/test_torch_prefix_serving.py``); for reduced ``mamba2_370m`` it
    still raises, naming ROADMAP item F4: the prefix cache holds KV blocks,
    not an SSM's state."""
    cfg = get_reduced_config("mamba2_370m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    stack = build_stack(cfg, _engine_cfg("vllm", True), "real", model=model, params=params,
                        max_len=MAX_LEN, device="cpu", dtype=torch.float32)
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, 24).tolist()
    engine = stack.engine
    first = Request(prompt_tokens=prompt[:16], max_new_tokens=2)
    engine.scheduler.add_request(first)
    while not first.finished:
        engine.step()
    engine.scheduler.add_request(Request(prompt_tokens=prompt, max_new_tokens=2))
    with pytest.raises(NotImplementedError, match="prefix.*ROADMAP Queue A item F4"):
        engine.step()
