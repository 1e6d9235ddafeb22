"""Real-mode serving of resumed preemptions (the reference runner's item P)
on the CPU.

Under memory pressure the engine preempts by recompute: the victim's KV
goes, and on resumption only its prompt is prefilled again, while the
tokens it generated stay in ``output_tokens`` (``Request.reset_for_recompute``).
The port's runner appends them to the final prompt chunk, so the slot holds
the whole context again and the token it returns is the one an unpreempted
run would have produced next.  On reduced ``llama3_8b`` (attention) and
``mamba2_370m`` (SSD, whose state K3's plain scan replays) in fp32, a block
pool too small for the four requests forces preemptions
(``num_preemptions > 0``), and every request's tokens equal those of the
same requests under a pool with room for all.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.models.transformer import build_model
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.serving.stack import build_stack

torch.set_num_threads(2)    # the suite runs in several workers at once

MAX_LEN = 128
BLOCK = 4
# (prompt length, max_new_tokens): 24 prompt blocks of 4 in all, and 14-16
# more as the decodes grow
WORKLOAD = [(21, 14), (17, 12), (25, 16), (19, 13)]


@pytest.fixture(scope="module", params=["llama3_8b", "mamba2_370m"])
def model(request):
    cfg = get_reduced_config(request.param)
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(3), torch.float32, "cpu")
    if request.param == "mamba2_370m":
        # slow decays, so that a state replayed wrongly would still show
        params["blocks"]["ssd"]["A_log"].fill_(np.log(0.02))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in WORKLOAD]
    return cfg, m, params, prompts


def _serve(cfg, m, params, prompts, num_blocks, policy):
    """Serve the workload; returns the stack, the requests and the tokens
    that the model's prefills took, warm-up excluded."""
    engine_cfg = EngineConfig(policy=policy, max_num_seqs=4, max_batched_tokens=32,
                              block_size=BLOCK, num_blocks=num_blocks,
                              enable_prefix_caching=False, chip="h100-sxm")
    stack = build_stack(cfg, engine_cfg, "real", model=m, params=params, max_len=MAX_LEN,
                        device="cpu", dtype=torch.float32)
    reqs = [Request(prompt_tokens=p, max_new_tokens=n) for p, (_, n) in zip(prompts, WORKLOAD)]
    prefilled = []
    prefill = m.prefill

    def counting(params, inputs, cache, **kw):
        prefilled.append(inputs["tokens"].shape[1])
        return prefill(params, inputs, cache, **kw)

    m.prefill = counting
    try:
        stack.engine.start()
        stack.engine.submit_many(reqs)
        assert stack.engine.wait_until_complete(len(reqs), timeout=240)
    finally:
        stack.shutdown()
        del m.prefill
    return stack, reqs, sum(prefilled)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("policy", ["vllm", "sglang"])
def test_preempted_requests_give_the_unpressured_tokens(model, policy):
    cfg, m, params, prompts = model
    roomy, expected, _ = _serve(cfg, m, params, prompts, 512, policy)
    tight, got, prefilled = _serve(cfg, m, params, prompts, 27, policy)
    assert roomy.engine.stats()["num_preemptions"] == 0
    assert tight.engine.stats()["num_preemptions"] > 0
    assert any(r.num_preemptions for r in got)
    for a, b in zip(got, expected):
        assert len(a.output_tokens) == a.max_new_tokens
        assert a.output_tokens == b.output_tokens, (a.num_preemptions, a.output_tokens,
                                                    b.output_tokens)
    # the replayed final chunks carried their requests' generated tokens:
    # the model prefilled more than the engine scheduled
    scheduled = sum(s.num_prefill_tokens for s in tight.engine.step_log)
    assert prefilled > scheduled
    assert tight.runner.num_free_slots == 4
