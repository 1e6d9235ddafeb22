"""The reference's ``kv_seq_shard`` opt (the KV sequence of a decode cell's
cache over "model", every KV head whole) in gloo groups of CPU processes,
against the one-process port model and the JAX model.

The cases (``tests/_torch_cp_cases.py`` runs them, all of one world size
in one launch of ``tests/_torch_serve_mesh_worker.py``):

* where the batch axes divide the batch, each "model" rank holds its
  block of the slots of every KV head: reduced ``llama3_8b`` over a linear
  row of 64 at (1, 2) and (2, 2), prefilled in two chunks (the second
  gathers the blocks over "model"); reduced ``mixtral_8x7b`` past its
  64-slot ring at (1, 2); reduced ``qwen2_5_3b`` at (1, 4), whose 2 KV
  heads put ``wk`` on head_dim while the cache holds both heads whole;
* at batch 1 on (2, 2) the sequence is already on "data", and the rules'
  "model" cut falls through to the heads, as the reference's
  ``try_assign`` refuses an assigned dimension.

Each holds every rank's logits after each prefill chunk and each of 3
decodes within 2e-4 of the one-process port model's (fp32) and 2e-3 of the
JAX model's, each rank's cache shapes to ``mesh.shard_shape`` of the rules
with ``seq_shard``, the block it holds (``SeqBlock`` over "model" or
"data"), the exchange under its name, and each rank's cache after the
prefill and after the decodes to the one-process cache's block
(``mesh.shard_cache(..., seq_shard=True)``).  The launcher runs ``--opt
kv_seq_shard`` as phase 36 does on the card, and the knobs reach the
config and the cache rules.
"""

import pytest
import torch

import _torch_cp_cases as cp
from _torch_cp_cases import DM, SS

torch.set_num_threads(2)    # the suite runs in several workers at once

# name: (arch, mesh names, mesh sizes, batch, prefill chunks, cache size, knobs)
CASES = {
    "llama3_8b_seq_shard_1x2": ("llama3_8b", DM, (1, 2), 2, (24, 16), 64, SS),
    "llama3_8b_seq_shard_2x2": ("llama3_8b", DM, (2, 2), 4, (24, 16), 64, SS),
    "mixtral_8x7b_seq_shard_ring_1x2": ("mixtral_8x7b", DM, (1, 2), 2, (80,), 96, SS),
    "qwen2_5_3b_seq_shard_1x4": ("qwen2_5_3b", DM, (1, 4), 2, (24, 16), 64, SS),
    "llama3_8b_seq_shard_falls_to_heads_2x2": ("llama3_8b", DM, (2, 2), 1, (24, 16), 64, SS),
}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return cp.run_groups(tmp_path_factory.mktemp("seq_shard"), CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_logits_match_one_process_and_jax(groups, name):
    cp.check_logits(groups[name])


@pytest.mark.parametrize("name", list(CASES))
def test_rank_blocks_are_the_rules_blocks(groups, name):
    cp.check_blocks(groups[name])


@pytest.mark.parametrize("name", list(CASES))
def test_rank_cache_is_the_one_process_cache_block(groups, name):
    cp.check_cache(groups[name])


@pytest.mark.parametrize("name", list(CASES))
def test_rank_census_equals_what_each_rank_issued(groups, name):
    cp.check_rank_census(groups[name])


def test_launcher_runs_kv_seq_shard_on_cpu_ranks():
    """``launch.parallel --opt kv_seq_shard`` as phase 36 runs it on the
    card, at reduced size: qwen2_5_3b at (1, 4) (``cp.check_launcher``)."""
    cp.check_launcher(["--arch", "qwen2_5_3b", "--mesh", "1,4", "--batch", "2", "--prompt", "24",
                       "--opt", "kv_seq_shard"])


def test_knobs_reach_the_config_and_the_cache_rules():
    """``--opt`` sets the config as the reference's ``build_cell`` does and
    ``kv_seq_shard`` reaches the cache rules; the cache length is rounded to
    whole pages on every rank that holds a block of it; an unknown knob is
    refused."""
    from repro_torch.launch import parallel
    base = ["--arch", "mixtral_8x7b", "--reduced", "--mesh", "1,4", "--decodes", "3"]
    args = parallel.parse_args(base + ["--prompt", "50", "--opt", "kv_defer_append", "--opt",
                                       "scores_bf16", "--opt", "kv_seq_shard", "--opt", "moe_a2a"])
    cfg = parallel.model_config(args)
    assert (cfg.kv_append, cfg.attn_scores_dtype, cfg.moe_impl) == ("defer", "bfloat16", "a2a")
    assert parallel.seq_shard(args) and parallel.cache_len(args) == 64
    plain = parallel.parse_args(base + ["--prompt", "70"])
    assert not parallel.seq_shard(plain) and parallel.cache_len(plain) == 80
    sharded = parallel.parse_args(base + ["--prompt", "70", "--opt", "kv_seq_shard"])
    assert parallel.cache_len(sharded) == 128
    with pytest.raises(SystemExit):
        parallel.parse_args(base + ["--opt", "no_such_knob"])
