"""``repro_torch.launch.rank_cost`` (one rank's program on the meta device, in
a stand-in process group of the mesh's size) against the reference's
``repro.launch.hlo_cost`` of the partitioned program, and its machinery.

* llama3_8b and whisper_base ``decode_32k`` at (16, 16): each sampled
  rank's product FLOPs and collective census against ``analyze_hlo`` of
  the reference's cell, lowered for its production mesh in a JAX
  subprocess (512 host devices, ``PYTHONDONTWRITEBYTECODE=1``) and counted
  as the port counts, products alone (its elementwise and reduction terms
  set to 0 in that process).  llama3_8b's FLOPs and all-reduce bytes
  agree within 1%; where the two programs move other tensors, the port's
  figures are held to what its program moves, within 1% of the count
  ``PERF.md`` §6 gives, and the reference's to what its own does
  (:func:`test_whisper_decode_parts_from_the_reference_where_its_attention_is_split`).
* The census's machinery: the ranks it samples and their numbering, the
  stand-in group torn down after each rank, the product counter against
  ``FlopCounterMode`` on the meta device and on CPU tensors.

The exact checks against real ranks are in the files that launch them:
``test_torch_serve_mesh.py``, ``test_torch_seq_shard.py``,
``test_torch_defer_mesh.py`` and ``test_torch_train_mesh.py``
(``test_rank_census_equals_what_each_rank_issued``).
"""

import importlib.util
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import dryrun, mesh, rank_cost
from repro_torch.models.optim import OptimizerConfig, init_adamw, make_train_step
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)    # the suite runs in several workers at once

REPO = Path(__file__).resolve().parent.parent
CELLS = ["llama3_8b/decode_32k", "whisper_base/decode_32k"]


def _script():
    """``scripts/census_against_reference.py``, which runs both sides."""
    spec = importlib.util.spec_from_file_location(
        "census_against_reference", REPO / "scripts" / "census_against_reference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def reference():
    """{"arch/shape": the reference's per-device product FLOPs, collective
    bytes by kind and ops} of CELLS at (16, 16), from a JAX subprocess."""
    return _script().reference(CELLS)


@pytest.fixture(scope="module")
def port():
    """{"arch/shape": ``rank_cost.cell_census``} of CELLS at (16, 16)."""
    return _script().port(CELLS)


def _close(got, exp, tol=0.01):
    return abs(got - exp) <= tol * abs(exp)


def test_llama3_decode_matches_the_reference(reference, port):
    """FLOPs and the all-reduce bytes within 1% (both exactly equal).  The
    all-gather: both programs gather each layer's K over "model" (the
    reference in fp32, the port K and V in the cache's bf16: the same
    bytes, 2·L·B·S·Hkv·D·2), and the reference also gathers the softmax's
    weights, which the port does not; so the port's reads that count
    within 1%, and the reference's more."""
    ref, got = reference["llama3_8b/decode_32k"], port["llama3_8b/decode_32k"]
    cfg = get_config("llama3_8b")
    assert _close(got["flops"], ref["flops"])
    for r in got["ranks"]:
        assert r["flops"] == got["flops"]          # no rank does more
        assert _close(r["bytes_by_op"]["all-reduce"], ref["bytes_by_op"]["all-reduce"])
    kv_rows = 2 * cfg.num_layers * (128 // 16) * 32768 * cfg.num_kv_heads * cfg.head_dim * 2
    gathered = got["collectives"]["bytes_by_op"]["all-gather"]
    assert _close(gathered, kv_rows)
    assert kv_rows < ref["bytes_by_op"]["all-gather"] <= 1.04 * kv_rows


def _whisper_attention(heads_dim, frames):
    """A whisper_base decode's attention FLOPs on one (16, 16) rank: 8 rows
    (128 over 16 "data" ranks), 8 heads of ``heads_dim`` channels, over
    32768 self keys and ``frames`` cross keys, in 6 decoder layers."""
    return 4 * 8 * 8 * heads_dim * (32768 + frames) * 6


def test_whisper_decode_parts_from_the_reference_where_its_attention_is_split(reference, port):
    """whisper_base's 8 heads do not split over 16 "model" ranks, so both
    programs cut the attention on head_dim.  The reference contracts its 4
    channels of each head and all-reduces the scores (fp32, 8 rows x 8
    heads x (32768 + 1500) keys a layer); the port's K2 attends whole
    heads, so each rank gathers its rows' K and V of both caches to whole
    heads (bf16; the frames in K2's 1504 slots) and attends for every head:
    16 times the attention FLOPs.  The rest is the same work: the
    reference's FLOPs less its attention plus the port's attention are the
    port's, within 1%; its K/V gather is what the port's all-gathers move,
    and the reference's scores what its all-reduces move, within 1%, and
    the port's all-reduces are the reference's without the scores."""
    ref, got = reference["whisper_base/decode_32k"], port["whisper_base/decode_32k"]
    ours, theirs = _whisper_attention(64, 1504), _whisper_attention(4, 1500)
    assert _close(got["flops"], ref["flops"] - theirs + ours)
    assert got["flops"] > 5 * ref["flops"]
    kv_rows = 2 * 6 * 8 * (32768 + 1504) * 8 * 64 * 2
    scores = 6 * 8 * 8 * (32768 + 1500) * 4
    assert _close(got["collectives"]["bytes_by_op"]["all-gather"], kv_rows)
    assert _close(ref["bytes_by_op"]["all-reduce"], scores)
    assert _close(got["collectives"]["bytes_by_op"]["all-reduce"],
                  ref["bytes_by_op"]["all-reduce"] - scores)


def test_sampled_ranks_and_their_numbering():
    """Rank 0 and each axis's last coordinate, numbered row-major as
    ``init_device_mesh`` lays the ranks out."""
    axes = mesh.MeshAxes(("pod", "data", "model"), (2, 16, 16))
    coords = rank_cost.sampled_coords(axes)
    assert coords == [{"pod": 0, "data": 0, "model": 0}, {"pod": 1, "data": 0, "model": 0},
                      {"pod": 0, "data": 15, "model": 0}, {"pod": 0, "data": 0, "model": 15}]
    assert [rank_cost.rank_of(axes, c) for c in coords] == [0, 256, 240, 15]
    assert rank_cost.sampled_coords(mesh.MeshAxes(("data", "model"), (1, 4))) == [
        {"data": 0, "model": 0}, {"data": 0, "model": 3}]
    for c in coords:
        with rank_cost.stand_in(axes, rank_cost.rank_of(axes, c)) as dm:
            assert {a: dm[a].get_local_rank() for a in axes.names} == c


def test_the_stand_in_group_is_torn_down_and_refuses_a_second():
    """A census leaves no process group behind, runs again in the same
    process, and refuses to start inside a group."""
    axes = mesh.MeshAxes(("data", "model"), (2, 2))
    cfg = get_reduced_config("llama3_8b")
    program = lambda: rank_cost.serve_program(cfg, 4, 32, [16, 1], dtype=torch.float32)
    first = rank_cost.census(axes, {"data": 1, "model": 1}, program)
    assert not dist.is_initialized()
    assert rank_cost.census(axes, {"data": 1, "model": 1}, program) == first
    assert first[0]["ops_by_op"]["all-reduce"] > 0 and first[1]["flops"] > 0
    assert set(first[0]["bytes_by_op"]) == set(rank_cost.KINDS)
    with rank_cost.stand_in(axes, 0):
        with pytest.raises(RuntimeError, match="default group"):
            rank_cost.census(axes, {"data": 0, "model": 0}, program)
    assert not dist.is_initialized()


def _train_step(device):
    cfg = get_reduced_config("qwen3_30b_a3b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, device)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(1, cfg.vocab_size, (4, 32), generator=gen).to(device)
             for k in ("tokens", "labels")}
    step = make_train_step(model, OptimizerConfig(), microbatches=2)
    return lambda: step(params, init_adamw(params), batch)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_product_counter_counts_what_flop_counter_mode_counts(device):
    """The census's counter against ``FlopCounterMode`` with the grouped
    product's formula, on a reduced MoE's train step (the dropless grouped
    products, remat, the backward pass): the same total, on the meta
    device (where it reuses repeated ops' outputs) and on CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    counts = []
    for counter in (FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten._grouped_mm: dryrun.grouped_mm_flops}), rank_cost.ProductCounter()):
        with counter:
            _train_step(device)()
        counts.append(counter.get_total_flops())
    assert counts[0] == counts[1] > 0
