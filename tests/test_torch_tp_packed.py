"""Tensor parallelism on the serve rules' cuts of packed projections, in gloo
groups of CPU processes, against the one-process port model and the JAX
model.

The rules cut two packed column axes into contiguous blocks: the SSD's
``w_in`` ([z | x | B | C | dt], ``launch.mesh``'s "w_in" rule) and, where
the experts do not divide over "model", an MoE's ``w_in`` ([gate | up]).
A rank holds exactly those blocks, and the layers exchange the columns a
rank needs (``layers._fetch_columns``).  Each group is 2, 4 or 8 processes
of ``tests/_torch_tp_worker.py`` that meet through a ``FileStore`` under
the test's temporary directory, started as
``tests/test_torch_tensor_parallel.py`` starts them; the weights are the
JAX model's (``jax.random.key(43)``), through the bridge and the ranks' cut
(``launch.mesh.shard_params``).  The cases:

* reduced ``mamba2_370m`` (d_model 64, d_inner 128, N 16, P 16, 8 heads,
  chunk 16; ``w_in`` 296 columns) at tp 2, 4 and 8 (148, 74 and 37
  columns, 4, 2 and 1 heads a rank): a 40-token prompt in chunks of 32 and
  8 (a ragged chunk of the port's scan; the reference's scan takes a chunk
  of min(16, T)), the second carrying the state and the conv state, then 4
  decodes;
* reduced ``mixtral_8x7b`` at tp 8: its 4 experts do not divide 8, so each
  rank holds 32 of ``w_in``'s 256 columns (ranks 0-3 gate, 4-7 up) and 16
  of ``w_out``'s 128 rows; its attention is on head_dim.

Each checks that every leaf of a rank's parameters and cache has the shape
``shard_shape`` gives its serve placement; that the logits of each prefill
chunk and of each decode lie within 2e-4 of the one-process port model's
(fp32) and within 2e-3 of the JAX model's, the same on every rank; that a
rank's SSD state is its heads of the one-process model's and its conv
state its block of the conv channels (2e-4), after the prefill and after
the decodes; and that the exchanges moved bytes (``layers.GATHERED``).  A
unit test reads, for the full configs at 2, 4, 8 and 16 ranks, which
columns of the packed axes each rank's blocks hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import mesh
from repro_torch.models.convert import from_numpy
from repro_torch.models.transformer import build_model
from test_torch_tensor_parallel import _FakeMesh, _start, _wait

torch.set_num_threads(2)    # the suite runs in several workers at once

DECODES = 4
CHUNKS = (32, 8)
CACHE = 48
# name: (arch, tp)
CASES = {"mamba2_370m_tp2": ("mamba2_370m", 2), "mamba2_370m_tp4": ("mamba2_370m", 4),
         "mamba2_370m_tp8": ("mamba2_370m", 8), "mixtral_8x7b_tp8": ("mixtral_8x7b", 8)}


def _case(arch):
    """(the worker's case, JAX logits after each chunk and each decode)."""
    jcfg = jax_reduced_config(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(43), jnp.float32)
    # jitted: eagerly, the JAX model took most of the file's time; the 2e-3
    # comparison does not see XLA's fusions
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    rng = np.random.default_rng(43)
    prompt = rng.integers(0, jcfg.vocab_size, (2, sum(CHUNKS)))
    fed = rng.integers(0, jcfg.vocab_size, (DECODES, 2, 1))
    cache = jm.init_cache(2, CACHE, jnp.float32)
    jlogits, s0 = [], 0
    for n in CHUNKS:
        logits, cache = prefill(jp, {"tokens": jnp.asarray(prompt[:, s0:s0 + n])}, cache)
        jlogits.append(np.asarray(logits))
        s0 += n
    for t in range(DECODES):
        logits, cache = decode(jp, cache, jnp.asarray(fed[t]))
        jlogits.append(np.asarray(logits))
    params = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return {"cfg": get_reduced_config(arch), "params": params, "prompt": torch.from_numpy(prompt),
            "chunks": list(CHUNKS), "fed": torch.from_numpy(fed), "cache_size": CACHE,
            "keep_cache": True}, jlogits


def _one_process(case):
    """The one-process model's logits at each step and its cache's values
    after the prefill and after the decodes."""
    model = build_model(case["cfg"])
    cache = model.init_cache(2, CACHE, torch.float32, "cpu")
    rows = torch.arange(2)
    logits, s0 = [], 0

    def values():
        return {n: leaf.clone() for n, leaf in mesh.leaves_with_names(cache)}

    with torch.no_grad():
        for n in CHUNKS:
            logits.append(model.prefill(case["params"], {"tokens": case["prompt"][:, s0:s0 + n]},
                                        cache)[0])
            s0 += n
        kept = [values()]
        for t in range(DECODES):
            logits.append(model.decode_slots(case["params"], cache, case["fed"][t], rows))
    return logits, kept + [values()]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{case name: (its worker case, the ranks' results, one-process logits
    and cache values, JAX logits)}: the groups of 2, 4 and 8 ranks run at
    once."""
    tmp = tmp_path_factory.mktemp("tp_packed")
    built = {arch: _case(arch) for arch in {a for a, _ in CASES.values()}}
    started = {}
    for world in sorted({tp for _, tp in CASES.values()}):
        cases = {name: built[arch][0] for name, (arch, tp) in CASES.items() if tp == world}
        started[world] = _start(world, tmp, cases)
    ranks = {world: _wait(world, *started[world]) for world in started}
    one = {arch: _one_process(built[arch][0]) for arch in built}
    return {name: (built[arch][0], [r[name] for r in ranks[tp]], one[arch], built[arch][1])
            for name, (arch, tp) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_rank_blocks_are_the_rules_blocks(groups, name):
    case, ranks, _, _ = groups[name]
    cfg, tp = case["cfg"], CASES[name][1]
    axes = mesh.MeshAxes(("data", "model"), (1, tp))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, "meta")
    cache = model.init_cache(2, CACHE, torch.float32, "meta")
    for what, tree, specs in (("params", params, mesh.param_specs(params, axes, "serve")),
                              ("cache", cache, mesh.cache_specs(cache, axes, batch=2))):
        spec_of = mesh.named_specs(specs)
        expect = {n: mesh.shard_shape(tuple(leaf.shape), spec_of[n], axes)
                  for n, leaf in mesh.leaves_with_names(tree)}
        for r in ranks:
            assert r[what] == expect
    got = ranks[0]["params"]
    if cfg.ssm is not None:
        assert got["blocks/ssd/w_in"][-1] == 296 // tp
        assert got["blocks/ssd/w_out"][-2] == 128 // tp
        assert ranks[0]["cache"]["layers/state"][2] == 8 // tp
        assert ranks[0]["cache"]["layers/conv"][-1] == 160 // tp
    else:
        assert got["blocks/moe/w_in"] == (2, 4, 64, 32)
        assert got["blocks/moe/w_out"] == (2, 4, 16, 64)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_logits_match_one_process_and_jax(groups, name):
    _, ranks, (one, _), jlogits = groups[name]
    assert len(ranks[0]["logits"]) == len(one) == len(jlogits) == len(CHUNKS) + DECODES
    for step, (got, exp, jexp) in enumerate(zip(ranks[0]["logits"], one, jlogits)):
        torch.testing.assert_close(got, exp, rtol=2e-4, atol=2e-4, msg=f"step {step}")
        np.testing.assert_allclose(got.numpy(), jexp, rtol=2e-3, atol=2e-3,
                                   err_msg=f"step {step}")
        for r in ranks[1:]:
            assert torch.equal(r["logits"][step], got)
    what = "ssd" if name.startswith("mamba2") else "moe_ffn"
    assert ranks[0]["gathered"].get(what, 0) > 0


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("mamba2")])
def test_rank_states_are_the_rules_blocks(groups, name):
    """Each rank's SSD state holds its heads of the one-process state
    (dimension 2 of (L, B, H, N, P)) and its conv state its block of the
    conv channels (the last of (L, B, K-1, d_inner + 2N)), after the
    prefill's two chunks and after the decodes."""
    _, ranks, (_, one), _ = groups[name]
    tp = CASES[name][1]
    for when in range(2):
        for m, r in enumerate(ranks):
            got = r["cache_values"][when]
            for leaf, dim in (("layers/state", 2), ("layers/conv", -1)):
                whole = one[when][leaf]
                n = whole.shape[dim] // tp
                torch.testing.assert_close(got[leaf], whole.narrow(dim, m * n, n), rtol=2e-4,
                                           atol=2e-4, msg=f"rank {m} {leaf} ({when})")


def _held(leaf_shape, tp):
    """Every rank's block of the last dimension of a leaf of
    ``leaf_shape`` that the serve rules place on "model": each column's
    index, as ``shard_params`` cuts a tree of that one leaf."""
    whole = torch.arange(leaf_shape[-1], dtype=torch.float32).expand(leaf_shape)
    return [mesh.shard_params({"blocks": {"ssd": {"w_in": whole}}}, _FakeMesh(m, tp))
            ["blocks"]["ssd"]["w_in"][(0,) * (len(leaf_shape) - 1)].long().tolist()
            for m in range(tp)]


def _segments(cols, parts):
    """{part: [first, last + 1) of it} of the columns ``cols`` (ascending),
    counted from the part's own start, for each part they touch."""
    out = {}
    for name, a, b in parts:
        inside = [c - a for c in cols if a <= c < b]
        if inside:
            assert inside == list(range(inside[0], inside[-1] + 1))
            out[name] = (inside[0], inside[-1] + 1)
    return out


# mamba2_370m at 4 ranks, written out: each rank's 1096 of the 4384 columns
MAMBA_TP4 = [{"z": (0, 1096)}, {"z": (1096, 2048), "x": (0, 144)}, {"x": (144, 1240)},
             {"x": (1240, 2048), "B": (0, 128), "C": (0, 128), "dt": (0, 32)}]


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
def test_ssd_blocks_of_the_packed_columns(tp):
    """Full mamba2_370m: ``w_in`` (1024, 4384) packs z 2048, x 2048, B 128,
    C 128 and dt 32; rank m holds columns [1096·4/tp·m, ...) of them, and
    its conv state the same contiguous block of the 2304 conv channels (x,
    B, C), which does not follow the heads; its ``w_out`` rows and state
    heads do."""
    cfg = get_config("mamba2_370m").replace(num_layers=1, layer_pattern=None)
    parts = [("z", 0, 2048), ("x", 2048, 4096), ("B", 4096, 4224), ("C", 4224, 4352),
             ("dt", 4352, 4384)]
    held = _held((1, 1024, 4384), tp)
    c = 4384 // tp
    assert held == [list(range(m * c, (m + 1) * c)) for m in range(tp)]
    for m, cols in enumerate(held):
        expect = {name: (max(a, m * c) - a, min(b, (m + 1) * c) - a) for name, a, b in parts
                  if max(a, m * c) < min(b, (m + 1) * c)}
        assert _segments(cols, parts) == expect
        if tp == 4:
            assert _segments(cols, parts) == MAMBA_TP4[m]
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16, "meta")
    for m in (0, tp - 1):
        rank = mesh.shard_params(params, _FakeMesh(m, tp))
        cache = model.init_cache(2, 16, torch.bfloat16, "meta", params=rank)["layers"]
        assert rank["blocks"]["ssd"]["w_out"].shape[-2] == 2048 // tp          # heads' channels
        assert cache["state"].shape[2] == 32 // tp and cache["conv"].shape[-1] == 2304 // tp
    whole = model.init_cache(2, 16, torch.bfloat16, "meta")
    specs = mesh.named_specs(mesh.cache_specs(whole, mesh.MeshAxes(("data", "model"), (1, tp)),
                                              batch=2))
    assert specs["layers/conv"][-1] == "model" and specs["layers/state"][2] == "model"


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
def test_expert_blocks_of_the_packed_columns(tp):
    """Full mixtral_8x7b: at 2, 4 and 8 ranks its 8 experts divide, and each
    rank holds all of [gate 14336 | up 14336] of its experts; at 16 they do
    not, and rank m holds columns [1792m, 1792(m+1)) of every expert's
    ``w_in`` (ranks 0-7 gate only, 8-15 up only) and rows [896m, 896(m+1))
    of ``w_out``, whose gate and up columns lie in the blocks of ranks
    m // 2 and 8 + m // 2."""
    cfg = get_config("mixtral_8x7b").replace(num_layers=1, layer_pattern=None)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), torch.bfloat16, "meta")
    dims = mesh.model_placements(params, tp)
    if tp < 16:
        assert (dims["blocks/moe/w_in"], dims["blocks/moe/w_out"]) == (-3, -3)
        rank = mesh.shard_params(params, _FakeMesh(tp - 1, tp))["blocks"]["moe"]
        assert rank["w_in"].shape[-3:] == (8 // tp, 4096, 28672)
        return
    assert (dims["blocks/moe/w_in"], dims["blocks/moe/w_out"]) == (-1, -2)
    index = torch.arange(28672, dtype=torch.float32).expand(1, 8, 1, 28672)
    held = [mesh.shard_params({"blocks": {"moe": {"w_in": index}}}, _FakeMesh(m, 16))
            ["blocks"]["moe"]["w_in"][0, 0, 0].long().tolist() for m in range(16)]
    parts = [("gate", 0, 14336), ("up", 14336, 28672)]
    for m, cols in enumerate(held):
        assert _segments(cols, parts) == ({"gate": (1792 * m, 1792 * (m + 1))} if m < 8 else
                                          {"up": (1792 * (m - 8), 1792 * (m - 7))})
        rows = range(896 * m, 896 * (m + 1))
        assert set(rows) <= set(held[m // 2])
        assert {14336 + r for r in rows} <= set(held[8 + m // 2])
    rank = mesh.shard_params(params, _FakeMesh(15, 16))["blocks"]["moe"]
    assert rank["w_out"].shape[-3:] == (8, 896, 4096)
