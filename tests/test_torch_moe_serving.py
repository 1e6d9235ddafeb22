"""Real-mode serving of the MoE and windowed models on the CPU against
per-request greedy decoding with the JAX ``TransformerLM``.

Reduced ``qwen3_30b_a3b`` (dropless MoE, top-2 of 4) and reduced
``mixtral_8x7b`` (MoE and a 64-token sliding window, with prompts longer
than the window, so that both the chunked prefill and the decodes attend
through it) are served through ``build_stack(mode="real")`` with a 48-token
step budget, so prompts arrive in several chunks and prefills run beside
decodes.  Each request's tokens must equal greedy decoding of the JAX model,
one request at a time, as ``tests/test_torch_serving.py`` holds the dense
model; the JAX cache gets a ``window_slack`` of the whole context, so that
its ring never overwrites a key a query still sees.
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

MAX_LEN = 192
# (prompt length, max_new_tokens): mixtral's window is 64, so most prompts
# pass it and every decode of the longest runs past it
WORKLOAD = [(90, 5), (131, 6), (41, 4), (70, 1)]
MARGIN = 1e-4


@pytest.fixture(scope="module", params=["qwen3_30b_a3b", "mixtral_8x7b"])
def setup(request):
    arch = request.param
    cfg = jax_reduced_config(arch)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(12), jnp.float32)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in WORKLOAD]

    prefill = jax.jit(jm.prefill)
    decode = jax.jit(jm.decode_step)
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

    model = build_model(get_reduced_config(arch))
    params = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return arch, model, params, prompts, greedy


@pytest.mark.timeout(300)
@pytest.mark.parametrize("policy", ["vllm", "sglang"])
def test_real_engine_matches_greedy_jax(setup, policy):
    arch, model, params, prompts, greedy = setup
    engine_cfg = EngineConfig(policy=policy, max_num_seqs=4, max_batched_tokens=48,
                              block_size=4, num_blocks=512, enable_prefix_caching=False,
                              chip="h100-sxm")
    stack = build_stack(get_reduced_config(arch), engine_cfg, "real", model=model,
                        params=params, max_len=MAX_LEN, device="cpu", dtype=torch.float32)
    reqs = [Request(prompt_tokens=p, max_new_tokens=n)
            for p, (_, n) in zip(prompts, WORKLOAD)]
    try:
        stack.engine.start()
        stack.engine.submit_many(reqs)
        assert stack.engine.wait_until_complete(len(reqs), timeout=240)
    finally:
        stack.shutdown()

    for req, expected in zip(reqs, greedy):
        assert req.output_tokens == expected, (arch, req.prompt_len, req.output_tokens,
                                               expected)
    assert stack.runner.num_free_slots == 4          # every slot came back
    chunked = [s for s in stack.engine.step_log if 0 < s.num_prefill_tokens]
    assert len(chunked) > len(WORKLOAD)              # prompts came in several chunks
