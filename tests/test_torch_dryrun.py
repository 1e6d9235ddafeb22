"""The port's dry-run on the meta device (``repro_torch.launch.{specs,dryrun}``)
against the reference's (``repro.launch.{specs,dryrun,hlo_cost}``).

* ``all_cells()`` is the reference's.
* ``memory.argument_bytes`` of three cells against the reference's per-device
  bytes: the sum over the cell's arguments of ``NamedSharding.shard_shape``
  times the element size, from the reference's own ``build_cell`` on its
  production mesh (one JAX subprocess with 512 host devices, which builds
  the cells and lowers nothing): qwen2_5_3b ``train_4k`` at 16x16,
  mixtral_8x7b ``decode_32k`` with ``moe_a2a`` at 16x16 and llama3_70b
  ``prefill_32k`` at 2x16x16.  Leaf for leaf equal, and so in total:
  mixtral's windowed K/V and position leaves included, whose rows keep the
  reference's ring of the window (4096 of the cell's 32768 positions).
* The FLOPs of every cell of the 13 configs against the analytical count
  (:func:`analytic_flops`: the products of the active parameters per token,
  the dense attention the plain version computes, the SSD scan's products)
  within ``FLOP_TOL``; each record's per-device FLOPs and collective census
  are its largest sampled rank's (``launch.rank_cost``), and the fault-C6
  cells no longer read the program's even split.
* The FLOPs of one reduced ``train_step`` against the reference's
  ``analyze_hlo`` of the same program compiled on one CPU device, within
  ``HLO_TOL``: the reference also counts elementwise ops and reductions,
  which ``FlopCounterMode`` does not.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import all_cells as jax_all_cells
from repro.configs import get_reduced_config as jax_reduced_config
from repro.launch.hlo_cost import analyze_hlo
from repro.models.optim import OptimizerConfig as JaxOptimizerConfig
from repro.models.optim import abstract_adamw
from repro.models.optim import make_train_step as jax_make_train_step
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import (ARCH_IDS, PAPER_ARCH_IDS, SHAPES, all_cells,
                                 applicable_shapes, get_config, get_reduced_config)
from repro_torch.launch import dryrun, rank_cost, specs
from repro_torch.launch.mesh import MeshAxes, leaves_with_names, shard_bytes
from repro_torch.models.optim import OptimizerConfig, init_adamw, make_train_step
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)    # the suite runs in several workers at once

REPO = Path(__file__).resolve().parent.parent
FLOP_TOL = 0.01     # relative, against analytic_flops
HLO_TOL = 0.03      # relative, against the reference's analyze_hlo (1.9% apart)

# (arch, shape, multi_pod, opts): the cells held against the reference's bytes
BYTE_CELLS = [("qwen2_5_3b", "train_4k", False, ()),
              ("mixtral_8x7b", "decode_32k", False, ("moe_a2a",)),
              ("llama3_70b", "prefill_32k", True, ())]

REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, sys
import jax, numpy as np
from repro.launch.mesh import _leaf_name, make_production_mesh
from repro.launch.specs import build_cell

out = []
for arch, shape, multi_pod, opts in json.loads(sys.argv[1]):
    cell = build_cell(arch, shape, make_production_mesh(multi_pod=multi_pod), opts=tuple(opts))
    per_arg = []
    for args, shardings in zip(cell.args, cell.in_shardings):
        leaves = {}
        flat = jax.tree_util.tree_flatten_with_path(args)[0]
        for (path, sds), sh in zip(flat, jax.tree_util.tree_leaves(shardings)):
            leaves[_leaf_name(path)] = (int(np.prod(sh.shard_shape(sds.shape)))
                                        * np.dtype(sds.dtype).itemsize)
        per_arg.append(leaves)
    out.append(per_arg)
print(json.dumps(out))
"""


def test_all_cells_are_the_references():
    assert all_cells() == jax_all_cells()
    assert len(all_cells()) == 33


@pytest.fixture(scope="module")
def reference_bytes():
    """Per cell of BYTE_CELLS, per argument, {leaf name: the reference's
    per-device bytes}."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(BYTE_CELLS)],
                          capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


def _port_leaf_bytes(tree, specs_tree, axes):
    """{leaf name: per-device bytes} of one argument, an AdamW state named
    by its fields as the reference's."""
    if hasattr(tree, "_asdict"):
        tree, specs_tree = tree._asdict(), specs_tree._asdict()
    names = dict(leaves_with_names(tree))
    spec_of = dict(leaves_with_names_specs(specs_tree))
    return {n: shard_bytes(leaf, spec_of[n], axes) for n, leaf in names.items()}


def leaves_with_names_specs(specs_tree, prefix=""):
    """(name, spec) of a spec tree, named as ``leaves_with_names`` names the
    tree it was made from (a spec is a tuple of entries, not a subtree)."""
    if isinstance(specs_tree, dict):
        for k, v in specs_tree.items():
            yield from leaves_with_names_specs(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(specs_tree, list):
        for i, v in enumerate(specs_tree):
            yield from leaves_with_names_specs(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, specs_tree


@pytest.mark.parametrize("i", range(len(BYTE_CELLS)), ids=[c[0] for c in BYTE_CELLS])
def test_argument_bytes_equal_the_references(reference_bytes, records, i):
    arch, shape, multi_pod, opts = BYTE_CELLS[i]
    axes = dryrun.production_axes(multi_pod)
    cell = specs.build_cell(arch, shape, axes, opts)
    ref = reference_bytes[i]
    total = 0
    for arg, spec, ref_leaves in zip(cell.args, cell.arg_specs, ref):
        if isinstance(arg, torch.Tensor):           # a lone tensor: the reference names it ""
            port = {"": shard_bytes(arg, spec, axes)}
        else:
            port = _port_leaf_bytes(arg, spec, axes)
        assert port.keys() == ref_leaves.keys()
        for name, nbytes in port.items():
            assert nbytes == ref_leaves[name], (name, nbytes, ref_leaves[name])
        total += sum(port.values())
    record = (records[(arch, shape)] if not (multi_pod or opts)
              else dryrun.run_cell(arch, shape, multi_pod, "", verbose=False, opts=opts))
    assert record["memory"]["argument_bytes"] == total
    assert total == sum(sum(r.values()) for r in ref)


# ---------------------------------------------------------------------------
# FLOPs against the analytical count
# ---------------------------------------------------------------------------

def _block_products(cfg, kind):
    """Parameters of one block that multiply each token (active experts only),
    norms and biases left out."""
    if kind in ("attn", "local_attn"):
        attn = cfg.d_model * (cfg.q_size + 2 * cfg.kv_size) + cfg.q_size * cfg.d_model
        return attn + cfg.active_mlp_params_per_layer()
    if kind == "ssd":
        ssm = cfg.ssm
        d_in, H = ssm.d_inner(cfg.d_model), ssm.num_heads(cfg.d_model)
        return (cfg.d_model * (2 * d_in + 2 * ssm.state_dim + H) + d_in * cfg.d_model
                + ssm.conv_width * (d_in + 2 * ssm.state_dim))
    w = cfg.rglru.lru_width
    return (3 * cfg.d_model * w + 2 * w * w + cfg.rglru.conv_width * w
            + cfg.active_mlp_params_per_layer())


def _attention(cfg, B, T, S, heads=None):
    """Forward FLOPs of the plain dense attention of T queries over S keys:
    every score and every weighted value, masked or not."""
    return 4 * B * T * S * (heads or cfg.num_heads) * cfg.head_dim


def _decode_keys(cfg, S):
    """The keys a decode attends over for a context of S, as the reference
    counts its work: a windowed layer's ring of min(S, window) positions,
    else all S.  (The port's block table over the ring reaches one page
    further back, ``transformer._page_tables``: 16 keys more, well inside
    FLOP_TOL.)"""
    if cfg.sliding_window:
        return min(S, cfg.sliding_window)
    return S


def _ssd_scan(cfg, B, T):
    """Forward FLOPs of the chunked SSD scan's products (``ref.ssd_scan_chunked``):
    C·Bᵀ and the intra-chunk mix, the chunk states and the inter-chunk
    output, per token."""
    ssm = cfg.ssm
    Q, N, P, H = min(ssm.chunk_size, T), ssm.state_dim, ssm.head_dim, ssm.num_heads(cfg.d_model)
    return B * T * (2 * Q * N + 2 * Q * H * P + 4 * N * H * P)


def _unrecomputed(cfg, kind):
    """Parameters of a block's last product, which remat does not run again:
    torch's non-reentrant checkpoint stops recomputing a block once the
    tensors its backward needs are back, and none needs the block's output
    (the MoE's grouped output is needed, by the gates' gradient)."""
    if kind == "ssd":
        return cfg.ssm.d_inner(cfg.d_model) * cfg.d_model
    return 0 if cfg.moe is not None else cfg.d_ff * cfg.d_model


def analytic_flops(cfg, shape_name):
    """The FLOPs a cell's entry needs: 2 a product per active parameter per
    token forward, the plain dense attention, the SSD scan; a train step
    runs each remat'd block's forward twice but its last product
    (:func:`_unrecomputed`) once, and its backward (twice the forward); the
    rest forward and backward."""
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    d, V = cfg.d_model, cfg.vocab_size
    F = cfg.frontend_tokens if cfg.frontend else 0
    text = S - F
    if cfg.is_enc_dec:
        enc = cfg.encoder.num_layers * (2 * (_block_products(cfg, "attn") * B * F)
                                        + _attention(cfg, B, F, F, cfg.encoder.num_heads))
        cross_kv = cfg.num_layers * 2 * (2 * d * cfg.kv_size) * B * F
        T = 1 if shape.kind == "decode" else text
        keys = S if shape.kind == "decode" else text
        frames = -(-F // 16) * 16 if shape.kind == "decode" else F   # K2's whole pages
        dec = cfg.num_layers * (2 * (_block_products(cfg, "attn") + 2 * d * cfg.q_size) * B * T
                                + _attention(cfg, B, T, keys) + _attention(cfg, B, T, frames))
        if shape.kind == "train":
            skipped = cfg.num_layers * 2 * _unrecomputed(cfg, "attn") * B * T
            return 3 * (enc + cross_kv) + 4 * dec - skipped + 6 * V * d * B * text
        if shape.kind == "prefill":
            return enc + cross_kv + dec + 2 * V * d * B
        return dec + 2 * V * d * B
    T = 1 if shape.kind == "decode" else S
    blocks = skipped = 0
    for kind in cfg.layer_pattern:
        skipped += 2 * _unrecomputed(cfg, kind) * B * T
        blocks += 2 * _block_products(cfg, kind) * B * T
        if kind in ("attn", "local_attn"):
            blocks += _attention(cfg, B, T, S if T > 1 else _decode_keys(cfg, S))
        elif kind == "ssd":
            # a decode's state update is an outer product (elementwise, not
            # counted) and its output one contraction over the state
            blocks += _ssd_scan(cfg, B, T) if T > 1 else 2 * B * cfg.ssm.state_dim * \
                cfg.ssm.head_dim * cfg.ssm.num_heads(d)
    if shape.kind == "train":
        return 4 * blocks - skipped + 6 * V * d * B * text
    return blocks + 2 * V * d * B


CELLS = [(a, s.name) for a in list(ARCH_IDS) + list(PAPER_ARCH_IDS)
         for s in applicable_shapes(get_config(a))]
SWEEPERS = 4        # processes that share the cells' meta runs

SWEEP = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
for arch, shape in json.loads(sys.argv[1]):
    dryrun.run_cell(arch, shape, False, sys.argv[2], verbose=False)
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{(arch, shape): the dry-run's record at 16x16} for every cell of
    CELLS, run by SWEEPERS processes at once (a train step's meta run takes
    up to a minute: one op at a time through the meta kernels), each given
    cells of about equal cost (a train step's layers times microbatches)."""
    tmp = tmp_path_factory.mktemp("dryrun")

    def cost(cell):
        cfg = get_config(cell[0])
        return (cfg.num_layers * specs.TRAIN_MICROBATCHES[cell[0]]
                if SHAPES[cell[1]].kind == "train" else 1)
    shares = [[] for _ in range(SWEEPERS)]
    for cell in sorted(CELLS, key=cost, reverse=True):
        min(shares, key=lambda sh: sum(map(cost, sh))).append(cell)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), PYTHONDONTWRITEBYTECODE="1")
    procs = [subprocess.Popen([sys.executable, "-c", SWEEP, json.dumps(sh), str(tmp / f"{i}.jsonl")],
                              env=env, cwd=REPO, stderr=subprocess.PIPE, text=True)
             for i, sh in enumerate(shares)]
    errors = [p.communicate(timeout=900)[1][-3000:] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(errors)
    out = {}
    for i in range(SWEEPERS):
        for line in (tmp / f"{i}.jsonl").read_text().splitlines():
            r = json.loads(line)
            out[(r["arch"], r["shape"])] = r
    return out


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_flops_match_the_analytical_count(records, arch, shape):
    record = records[(arch, shape)]
    expect = analytic_flops(get_config(arch), shape)
    got = record["cost"]["flops_program"]
    assert abs(got - expect) <= FLOP_TOL * expect, (got, expect, got / expect)
    # per device: the largest of the sampled ranks' (launch.rank_cost), each
    # at least its even share of the program
    ranks = record["ranks"]
    assert record["cost"]["flops"] == max(r["flops"] for r in ranks)
    assert min(r["flops"] for r in ranks) >= got / record["chips"] * (1 - 1e-9)
    assert [r["coords"] for r in ranks] == rank_cost.sampled_coords(
        dryrun.production_axes(False))
    assert record["memory"]["argument_bytes"] > 0 and record["memory"]["output_bytes"] > 0
    assert _keys(record) - {"cost.flops_program", "null_fields", "device", "census_s",
                            "ranks"} == REFERENCE_KEYS
    assert record["memory"]["temp_bytes"] is None
    collectives = record["collectives"]
    assert set(collectives["bytes_by_op"]) == set(rank_cost.KINDS)
    assert collectives["total_bytes"] == sum(collectives["bytes_by_op"].values())
    # every cell's mesh splits it over "model" (and its rows or sequence
    # over "data"): some rank gathers or reduces
    assert collectives["total_ops"] > 0 and collectives["total_bytes"] > 0
    assert collectives["while_loops"] is None and collectives["unknown_trip_loops"] is None
    assert set(record["null_fields"]) >= {"memory.temp_bytes", "collectives.while_loops"}
    assert "collectives" not in record["null_fields"]


# fault C6: the per-device FLOPs were the program's divided by the chips
# (llama3_8b's decode, whisper_base's decode, qwen2_5_3b's training step);
# the reference's analyze_hlo of each cell at 16x16, products alone
C6_REFERENCE = {("llama3_8b", "decode_32k"): 16_094_593_024,
                ("whisper_base", "decode_32k"): 657_440_768,
                ("qwen2_5_3b", "train_4k"): 413_212_361_097_216}


def test_fault_c6_cells_read_their_ranks_not_the_even_split(records):
    """The fault-C6 cells' per-device FLOPs are their largest rank's.
    llama3_8b's decode splits evenly in both programs and equals the
    reference's.  whisper_base's decode does not split evenly: its 8 heads
    do not divide over 16 "model" ranks, and each rank's K2 attends every
    head over its rows' K and V gathered to whole heads, so a rank does
    14.7 times its even share, 5.8 times the reference's, which splits the
    attention on head_dim (PERF.md §6).  qwen2_5_3b's step splits evenly in
    the port (its rank reads the even share, now from the rank's own
    program), a quarter of the reference's, whose partitioner runs every
    head's attention on every "model" rank (PERF.md §6)."""
    ratio = {}
    for cell, ref in C6_REFERENCE.items():
        record = records[cell]
        even = record["cost"]["flops_program"] / record["chips"]
        assert record["cost"]["flops"] == max(r["flops"] for r in record["ranks"])
        ratio[cell] = (record["cost"]["flops"] / even, record["cost"]["flops"] / ref)
    assert ratio[("llama3_8b", "decode_32k")] == (1.0, 1.0)
    assert 14 < ratio[("whisper_base", "decode_32k")][0] < 15
    assert 5.7 < ratio[("whisper_base", "decode_32k")][1] < 5.9
    assert ratio[("qwen2_5_3b", "train_4k")][0] == 1.0
    assert 0.26 < ratio[("qwen2_5_3b", "train_4k")][1] < 0.28


# the keys of a record of the reference's ``run_cell`` (``src/repro/launch/dryrun.py:128-169``)
REFERENCE_KEYS = {
    "arch", "shape", "opts", "entry", "mesh", "axes", "chips", "tokens_per_step",
    "model_params", "model_active_params", "lower_s", "compile_s",
    "memory.argument_bytes", "memory.output_bytes", "memory.temp_bytes", "memory.alias_bytes",
    "memory.peak_per_device", "cost.flops", "cost.bytes_accessed",
    "collectives.bytes_by_op", "collectives.total_bytes", "collectives.total_ops",
    "collectives.while_loops", "collectives.unknown_trip_loops",
    "xla_cost.flops", "xla_cost.bytes_accessed",
    "collectives_flat.bytes_by_op", "collectives_flat.counts_by_op",
    "collectives_flat.total_bytes", "collectives_flat.total_ops"}


def _keys(record, prefix=""):
    """A record's keys, nested ones joined by "." (``null_fields`` and the
    dictionaries by collective kind whole, as the reference's keys list
    them)."""
    out = set()
    for k, v in record.items():
        if isinstance(v, dict) and k not in ("null_fields", "bytes_by_op", "counts_by_op"):
            out |= _keys(v, f"{prefix}{k}.")
        else:
            out.add(prefix + k)
    return out


# ---------------------------------------------------------------------------
# one reduced train step against the reference's analyze_hlo
# ---------------------------------------------------------------------------

def test_reduced_train_step_flops_match_analyze_hlo():
    """Reduced llama3_8b widened so that products dominate (d_model 512, FFN
    2048, vocab 4096), batch 4 of 512 in 2 microbatches with remat, bf16: the
    port's meta run against the reference's ``analyze_hlo`` of the same step
    compiled on one CPU device."""
    widths = dict(d_model=512, num_heads=8, num_kv_heads=2, head_dim=64, d_ff=2048,
                  vocab_size=4096)
    B, T, mb = 4, 512, 2
    jcfg = jax_reduced_config("llama3_8b").replace(**widths)
    jmodel = jax_build_model(jcfg)
    p_sds = jmodel.abstract_params(jnp.bfloat16)
    batch_sds = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((B, T), jnp.int32)}
    step = jax_make_train_step(jmodel, JaxOptimizerConfig(), microbatches=mb, remat=True)
    compiled = jax.jit(step).lower(p_sds, abstract_adamw(p_sds), batch_sds).compile()
    ref = analyze_hlo(compiled.as_text()).flops

    cfg = get_reduced_config("llama3_8b").replace(**widths)
    model = build_model(cfg)
    params = specs.abstract_params(model)
    batch = {k: torch.empty((B, T), dtype=torch.int32, device="meta") for k in ("tokens", "labels")}
    train_step = make_train_step(model, OptimizerConfig(), microbatches=mb, remat=True)
    with dryrun.flop_counter() as counter:
        train_step(params, init_adamw(params), batch)
    got = counter.get_total_flops()
    assert abs(got - ref) <= HLO_TOL * ref, (got, ref, got / ref)
    assert abs(got - analytic_flops_reduced(cfg, B, T)) <= FLOP_TOL * got


def analytic_flops_reduced(cfg, B, T):
    blocks = cfg.num_layers * (2 * _block_products(cfg, "attn") * B * T
                               + _attention(cfg, B, T, T))
    skipped = cfg.num_layers * 2 * _unrecomputed(cfg, "attn") * B * T
    return 4 * blocks - skipped + 6 * cfg.vocab_size * cfg.d_model * B * T


def test_dry_run_needs_no_card_and_keeps_the_reference_knobs():
    assert specs.OPTS == ("kv_seq_shard", "moe_a2a", "scores_bf16", "kv_defer_append")
    with pytest.raises(ValueError, match="unknown opts"):
        specs.build_cell("olmo_1b", "decode_32k", MeshAxes(("data", "model"), (1, 1)), ("fast",))
    cell = specs.build_cell("olmo_1b", "decode_32k", MeshAxes(("data", "model"), (1, 1)))
    assert all(leaf.is_meta for _, leaf in leaves_with_names(cell.args))
