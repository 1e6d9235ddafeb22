"""The deferred append and an encoder-decoder's cross cache under a KV
sequence cut over "data" (context parallelism), and both under
``kv_seq_shard``, in gloo groups of CPU processes, against the one-process
port model and the JAX model.

The cases (``tests/_torch_cp_cases.py`` runs them, all of one world size
in one launch of ``tests/_torch_serve_mesh_worker.py``):

* ``kv_append="defer"`` at batch 1: reduced ``llama3_8b`` over a linear
  row of 64 at (2, 1), in two chunks (the second gathers the blocks);
  ``mixtral_8x7b`` and ``recurrentgemma_2b`` past their 64-slot rings at
  (2, 2) (the latter's one KV head on head_dim over "model", each layer
  appended right after it); ``mixtral_8x7b`` at batch 2 under
  ``kv_seq_shard`` at (1, 2), the ring over "model";
* reduced ``whisper_base`` with 32 frames a row: at batch 1 on (2, 1), its
  self-attention cache and its cross cache over "data"; at batch 2 on
  (1, 2) under ``kv_seq_shard``, both over "model"; a second prefill chunk
  without frames gathers the frames' blocks.  The same at (4, 1) and
  (1, 4) with 36 frames, whose quarter (9) is not whole pages: each rank
  holds its 9 frames in 16 slots, the pad after them, as whisper's 1500
  frames give 375 a rank in 384 slots.

Each is held as in ``tests/test_torch_seq_shard.py``: logits at every step
within 2e-4 of one process and 2e-3 of JAX, cache shapes and blocks by the
rules, each rank's cache its block of the one-process cache, the deferred
positions written only by the rank whose block holds their slots.
``block_runs`` under the deferred append is held to the keys a query sees
of the cache before its token, on every position of wrapped rings; the
launcher serves whisper's frames over "data" as phase 37 does on the card.
"""

import pytest
import torch

import _torch_cp_cases as cp
from _torch_cp_cases import DEFER, DM, SS
from repro_torch.models import transformer
from repro_torch.models.transformer import SeqBlock

torch.set_num_threads(2)    # the suite runs in several workers at once

# name: (arch, mesh names, mesh sizes, batch, prefill chunks, cache size, knobs)
CASES = {
    "llama3_8b_defer_seq_2x1": ("llama3_8b", DM, (2, 1), 1, (24, 16), 64, DEFER),
    "mixtral_8x7b_defer_ring_2x2": ("mixtral_8x7b", DM, (2, 2), 1, (80,), 96, DEFER),
    "recurrentgemma_2b_defer_ring_2x2": ("recurrentgemma_2b", DM, (2, 2), 1, (80,), 96, DEFER),
    "mixtral_8x7b_defer_seq_shard_ring_1x2": ("mixtral_8x7b", DM, (1, 2), 2, (80,), 96,
                                              dict(SS, **DEFER)),
    "whisper_base_cross_2x1": ("whisper_base", DM, (2, 1), 1, (12, 4), 32, {"frames": 32}),
    "whisper_base_cross_seq_shard_1x2": ("whisper_base", DM, (1, 2), 2, (12, 4), 32,
                                         dict(SS, frames=32)),
    # 36 frames: 9 a rank, stored in a page of 16 slots, the pad after them
    "whisper_base_cross_4x1": ("whisper_base", DM, (4, 1), 1, (12, 4), 64, {"frames": 36}),
    "whisper_base_cross_seq_shard_1x4": ("whisper_base", DM, (1, 4), 2, (12, 4), 64,
                                         dict(SS, frames=36)),
}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return cp.run_groups(tmp_path_factory.mktemp("defer_mesh"), CASES)


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


@pytest.mark.parametrize("S,D,window", [(64, 2, 64), (64, 4, 64), (64, 2, 48), (64, 2, None),
                                        (128, 4, 80), (64, 2, 1)])
def test_deferred_block_runs_read_the_cache_before_the_token_once(S, D, window):
    """Over every query position (past several wraps of a ring; up to the
    row's end for a linear one), the keys the ranks' launches read of the
    cache before the token is written are p − window + 1 .. p − 1 (all of
    0 .. p − 1 without a window, none at a window of 1), each on one rank,
    once: never the slot p % S, which still holds p − S or nothing."""
    last = 5 * S if window else S
    for p in range(last):
        held = cp.stale_runs_read(p, S, D, window)
        seen = sorted(q for qs in held.values() for q in qs)
        lo = 0 if window is None else max(0, p - window + 1)
        assert seen == list(range(lo, p)), (p, held)
        assert all(len(transformer.block_runs([p], SeqBlock(d, D, S), window, True)) <= 2
                   for d in range(D))


def test_launcher_serves_frames_over_data_on_cpu_ranks():
    """``launch.parallel`` with whisper's frames over "data" at batch 1, as
    phase 37 runs it on the card, at reduced size (``cp.check_launcher``)."""
    cp.check_launcher(["--arch", "whisper_base", "--mesh", "2,1", "--batch", "1", "--prompt",
                       "12", "--frames", "32"])


def test_launcher_serves_frames_over_four_data_ranks_on_cpu_ranks():
    """The same at (4, 1), as phase 37b runs it on the card: 36 frames, 9
    a rank in 16 slots (``cp.check_launcher``; ``parallel.check`` holds
    each rank's cache shapes to ``mesh.cache_shapes``)."""
    cp.check_launcher(["--arch", "whisper_base", "--mesh", "4,1", "--batch", "1", "--prompt",
                       "12", "--frames", "36"])
