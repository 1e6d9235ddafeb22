"""Serving on a ("data", "model") and a ("pod", "data", "model") mesh, as the
reference's decode cells place it, in gloo groups of CPU processes, against
the one-process port model and the JAX model.

Each group is 2 or 4 processes of ``tests/_torch_serve_mesh_worker.py``
that meet through a ``FileStore`` under the test's temporary directory.
The weights are the JAX model's (``jax.random.key(43)``), through the
bridge and the ranks' cut (``launch.mesh.shard_params``).  The cases:

* reduced ``llama3_8b`` with its rows over "data" at (2, 1) and (2, 2);
* the same at batch 1 on (2, 2): context parallel over a linear cache of
  64 slots, 32 a "data" rank, prefilled in two chunks (the second gathers
  the first's blocks) so that each rank's block holds keys;
* reduced ``mixtral_8x7b`` at batch 1 on (2, 2), its 64-slot ring over
  "data": an 80-token prompt wraps the ring, so rank 0's block holds two
  runs (the query's own slots and older ones) and rank 1's one; a
  20-token prompt leaves rank 1's block empty (lse -inf) through the
  decodes; its experts over "model", their d over "data";
* reduced ``recurrentgemma_2b`` at batch 1 on (2, 2): its ring over
  "data", its one KV head on head_dim over "model", the RG-LRU's width
  over "model" and its state whole over "data";
* reduced ``qwen3_30b_a3b`` with its rows over "data" at (2, 2): the
  experts' d over "data", gathered where they run;
* reduced ``mamba2_370m`` with its rows over "data" at (2, 1);
* the ("pod", "data", "model") mesh at (2, 2, 1) and (2, 1, 2), at batch 1
  (the KV sequence over "data", the pods replicas) and at a batch the
  batch axes divide (rows pod-major over ("pod", "data")).

Each holds every rank's logits after each prefill chunk and each of 3
decodes within 2e-4 of the one-process port model's (fp32) and within 2e-3
of the JAX model's (jitted; its ring given the whole context through
``window_slack``), each rank's parameter and cache shapes to
``mesh.shard_shape`` of the serve rules at the mesh, and each rank's cache
(K, V, ``kv_pos``, recurrent states, lengths) after the prefill and after
the decodes to the one-process cache's block of the rules
(``mesh.shard_cache``).  ``transformer.block_runs`` is held to the keys a
query sees, rank by rank, on rings and linear rows.  The launcher
(``repro_torch.launch.parallel --mesh``) serves reduced mixtral at (2, 2)
and qwen3 at (2, 1, 2), as phases 33-34 do on the card.  A block that is
not whole pages of K2 raises.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_reduced_config
from repro_torch.launch import mesh
from repro_torch.models import layers, transformer
from repro_torch.models.convert import from_numpy
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)    # the suite runs in several workers at once

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_serve_mesh_worker.py"
DECODES = 3
DM, PDM = ("data", "model"), ("pod", "data", "model")
# name: (arch, mesh names, mesh sizes, batch, prefill chunks, cache size)
CASES = {
    "llama3_8b_rows_2x1": ("llama3_8b", DM, (2, 1), 2, (16,), 32),
    "mamba2_370m_rows_2x1": ("mamba2_370m", DM, (2, 1), 2, (32,), 48),
    "llama3_8b_rows_2x2": ("llama3_8b", DM, (2, 2), 4, (16,), 32),
    "llama3_8b_seq_2x2": ("llama3_8b", DM, (2, 2), 1, (24, 16), 64),
    "mixtral_8x7b_ring_2x2": ("mixtral_8x7b", DM, (2, 2), 1, (80,), 96),
    "mixtral_8x7b_empty_block_2x2": ("mixtral_8x7b", DM, (2, 2), 1, (20,), 96),
    "recurrentgemma_2b_ring_2x2": ("recurrentgemma_2b", DM, (2, 2), 1, (80,), 96),
    "qwen3_30b_a3b_rows_2x2": ("qwen3_30b_a3b", DM, (2, 2), 4, (16,), 32),
    "qwen3_30b_a3b_rows_2x2x1": ("qwen3_30b_a3b", PDM, (2, 2, 1), 4, (16,), 32),
    "mixtral_8x7b_seq_2x2x1": ("mixtral_8x7b", PDM, (2, 2, 1), 1, (80,), 96),
    "llama3_8b_rows_2x1x2": ("llama3_8b", PDM, (2, 1, 2), 2, (16,), 32),
    "mixtral_8x7b_seq_2x1x2": ("mixtral_8x7b", PDM, (2, 1, 2), 1, (40,), 96),
}


def _world(name):
    return int(np.prod(CASES[name][2]))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The reduced JAX model's weights from ``jax.random.key(43)`` and the
    port's copy through the bridge, drawn once an arch (cases share them)."""
    jp = jax_build_model(jax_reduced_config(arch)).init(jax.random.key(43), jnp.float32)
    return jp, from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _case(name):
    """(the worker's case, a function that returns the JAX logits at each
    step), the JAX model being run only when it is called."""
    arch, names, sizes, B, chunks, cache_size = CASES[name]
    jcfg = jax_reduced_config(arch)
    jm = jax_build_model(jcfg)
    jp, params = _jax_params(arch)
    rng = np.random.default_rng(43)
    prompt = rng.integers(0, jcfg.vocab_size, (B, sum(chunks)))
    fed = rng.integers(0, jcfg.vocab_size, (DECODES, B, 1))

    def jax_logits():
        # jitted: run eagerly, the JAX model took most of the file's time
        # (84 s of the 12 cases on one CPU process), and the 2e-3
        # comparison does not see XLA's fusions
        prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
        # the JAX ring holds the whole context, so that a chunk may outrun it
        cache = jm.init_cache(B, cache_size, jnp.float32, window_slack=cache_size)
        out, s0 = [], 0
        for n in chunks:
            logits, cache = prefill(jp, {"tokens": jnp.asarray(prompt[:, s0:s0 + n])}, cache)
            out.append(np.asarray(logits))
            s0 += n
        for t in range(DECODES):
            logits, cache = decode(jp, cache, jnp.asarray(fed[t]))
            out.append(np.asarray(logits))
        return out

    case = {"cfg": get_reduced_config(arch), "mesh": (names, sizes), "params": params,
            "prompt": torch.from_numpy(prompt), "chunks": list(chunks),
            "fed": torch.from_numpy(fed), "cache_size": cache_size}
    return case, jax_logits


def _one_process(case):
    """(logits at each step, the cache's values after the prefill and after
    the decodes) of the one-process port model on the whole batch."""
    model = build_model(case["cfg"])
    B = case["prompt"].shape[0]
    cache = model.init_cache(B, case["cache_size"], torch.float32, "cpu")
    rows = torch.arange(B)
    logits, kept, s0 = [], [], 0
    with torch.no_grad():
        for n in case["chunks"]:
            logits.append(model.prefill(case["params"], {"tokens": case["prompt"][:, s0:s0 + n]},
                                        cache)[0])
            s0 += n
        kept.append({k: v.clone() for k, v in mesh.leaves_with_names(cache)})
        for t in range(DECODES):
            logits.append(model.decode_slots(case["params"], cache, case["fed"][t], rows))
        kept.append(dict(mesh.leaves_with_names(cache)))
    return logits, kept


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), PYTHONDONTWRITEBYTECODE="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{case name: (its worker case, the ranks' results, the one-process
    logits and cache values, JAX logits)}: the groups of 2 and 4 ranks run
    at once, while the JAX model runs here."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    built = {name: _case(name) for name in CASES}
    started = {}
    for world in sorted({_world(n) for n in CASES}):
        path = tmp / f"cases{world}.pt"
        torch.save({n: built[n][0] for n in CASES if _world(n) == world}, path)
        out = tmp / f"world{world}"
        out.mkdir()
        started[world] = out, [subprocess.Popen(
            [sys.executable, str(WORKER), str(world), str(r), str(tmp / f"store{world}"),
             str(out), str(path)], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
    jlogits = {name: built[name][1]() for name in CASES}
    ranks = {}
    for world, (out, procs) in started.items():
        errors = []
        for p in procs:
            _, err = p.communicate(timeout=240)
            if p.returncode:
                errors.append(err[-3000:])
        assert not errors, "\n".join(errors)
        ranks[world] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                        for r in range(world)]
    return {name: (built[name][0], [r[name] for r in ranks[_world(name)]],
                   _one_process(built[name][0]), jlogits[name]) for name in CASES}


class _Coords:
    """A device mesh's axes and one rank's coordinates on them, as
    ``launch.mesh`` and ``models.layers`` read them."""

    def __init__(self, names, sizes, coords):
        self.mesh_dim_names = tuple(names)
        subs = {a: (coords[a], n) for a, n in zip(names, sizes)}
        if "pod" in names:
            subs[layers.BATCH_DIM] = (coords["pod"] * subs["data"][1] + coords["data"],
                                      subs["pod"][1] * subs["data"][1])
        self.subs = {a: type("Sub", (), {"get_local_rank": lambda _, i=i: i,
                                         "size": lambda _, n=n: n})()
                     for a, (i, n) in subs.items()}

    def __getitem__(self, name):
        return self.subs[name]


def _expected_shapes(case):
    """{"params", "cache"}: {leaf: shard_shape of its serve placement at the
    case's mesh}, from the whole trees on the meta device."""
    names, sizes = case["mesh"]
    axes = mesh.MeshAxes(names, sizes)
    model = build_model(case["cfg"])
    params = model.init(torch.Generator().manual_seed(0), torch.float32, "meta")
    B = case["prompt"].shape[0]
    cache = model.init_cache(B, case["cache_size"], torch.float32, "meta")
    out = {}
    for what, tree, specs in (("params", params, mesh.param_specs(params, axes, "serve")),
                              ("cache", cache, mesh.cache_specs(cache, axes, batch=B))):
        spec_of = mesh.named_specs(specs)
        out[what] = {n: mesh.shard_shape(tuple(leaf.shape), spec_of[n], axes)
                     for n, leaf in mesh.leaves_with_names(tree)}
    return out


def rank_census(case, rank):
    """The census of the rank at ``rank["coords"]`` on the meta device
    (``launch.rank_cost.serve_program`` in a stand-in group of the case's
    mesh): each prefill chunk's and each decode's product FLOPs and
    collectives, its experts' gathers sized by what the rank recorded."""
    from repro_torch.launch import rank_cost
    names, sizes = case["mesh"]
    frames = case.get("frames")
    lengths = list(case["chunks"]) + [1] * case["fed"].shape[0]
    return rank_cost.census(mesh.MeshAxes(names, sizes), rank["coords"], lambda: (
        rank_cost.serve_program(case["cfg"], case["prompt"].shape[0], case["cache_size"],
                                lengths, dtype=torch.float32,
                                seq_shard=case.get("seq_shard", False),
                                frames=0 if frames is None else frames.shape[1],
                                kept=rank["experts_kept"])))


def check_census(case, ranks):
    """Every rank's census on the meta device (:func:`rank_census`) equals
    what the rank recorded at each prefill chunk and each decode: the
    collectives' result bytes and ops by kind exactly, and the product
    FLOPs exactly where no grouped product runs on a rank's block of the
    experts (whose meta run counts every row it is given, a real rank the
    routed ones alone: at most the census's)."""
    exact_flops = case["cfg"].moe is None
    for r in ranks:
        got = rank_census(case, r)
        assert len(got) == len(r["census"])
        for step, (meta, real) in enumerate(zip(got, r["census"])):
            where = f"rank {r['coords']} step {step}"
            assert meta["bytes_by_op"] == real["bytes_by_op"], where
            assert meta["ops_by_op"] == real["ops_by_op"], where
            if exact_flops:
                assert meta["flops"] == real["flops"], where
            else:
                assert real["flops"] <= meta["flops"], where


@pytest.mark.parametrize("name", list(CASES))
def test_rank_census_equals_what_each_rank_issued(groups, name):
    """``launch.rank_cost``'s census of every rank, each prefill chunk and
    each decode, against what the gloo ranks recorded (:func:`check_census`):
    rows over the batch axes, the KV sequence over "data", the experts' d
    gathered over them, pod meshes."""
    case, ranks, _, _ = groups[name]
    check_census(case, ranks)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_blocks_are_the_rules_blocks(groups, name):
    case, ranks, _, _ = groups[name]
    expect = _expected_shapes(case)
    cfg, (_, sizes), B = case["cfg"], case["mesh"], case["prompt"].shape[0]
    batch_ranks = int(np.prod(sizes[:-1]))
    for r in ranks:
        assert r["params"] == expect["params"]
        assert r["cache"] == expect["cache"]
        # rows pod-major over the batch axes, or every row
        i = r["coords"].get("pod", 0) * sizes[-2] + r["coords"]["data"]
        rows = (i * B // batch_ranks, (i + 1) * B // batch_ranks) if B % batch_ranks == 0 \
            else (0, B)
        assert r["rows"] == rows
    if cfg.moe is not None:       # the experts' d over the batch axes, gathered where run
        assert ranks[0]["params"]["blocks/moe/w_in"][-2] == cfg.d_model // batch_ranks
        assert ranks[0]["gathered"]["experts"] > 0
    split = B % batch_ranks != 0 and sizes[-2] > 1 and cfg.ssm is None
    assert (ranks[0]["block"] is not None) == split
    assert (ranks[0]["gathered"].get("merge", 0) > 0) == (ranks[0]["block"] is not None)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_logits_match_one_process_and_jax(groups, name):
    case, ranks, (one, _), jlogits = groups[name]
    assert len(one) == len(jlogits) == len(case["chunks"]) + DECODES
    for r in ranks:
        rows = slice(*r["rows"])
        assert len(r["logits"]) == len(one)
        for step, (got, exp, jexp) in enumerate(zip(r["logits"], one, jlogits)):
            torch.testing.assert_close(got, exp[rows], rtol=2e-4, atol=2e-4,
                                       msg=f"rank coords {r['coords']} step {step}")
            np.testing.assert_allclose(got.numpy(), jexp[rows], rtol=2e-3, atol=2e-3,
                                       err_msg=f"rank coords {r['coords']} step {step}")
    for r in ranks[1:]:            # the ranks that serve the same rows agree exactly
        same = [q for q in ranks if q["rows"] == r["rows"]]
        for step in range(len(one)):
            assert torch.equal(r["logits"][step], same[0]["logits"][step])


@pytest.mark.parametrize("name", list(CASES))
def test_rank_cache_is_the_one_process_cache_block(groups, name):
    """After the prefill and after the decodes, each rank's cache is its
    block of the one-process cache by the rules (``mesh.shard_cache``): its
    rows, or slots [d·S/D, (d+1)·S/D) of each row's K, V and ``kv_pos``
    (the tags exactly), with its "model" blocks."""
    case, ranks, (_, kept), _ = groups[name]
    names, sizes = case["mesh"]
    B = case["prompt"].shape[0]
    for r in ranks:
        fake = _Coords(names, sizes, r["coords"])
        for when, (got, whole) in enumerate(zip(r["cache_values"], kept)):
            exp = dict(mesh.leaves_with_names(mesh.shard_cache(
                {n: v for n, v in whole.items()}, fake, batch=B)))
            assert got.keys() == exp.keys()
            for n in exp:
                if got[n].dtype.is_floating_point:
                    torch.testing.assert_close(got[n], exp[n], rtol=1e-4, atol=1e-4,
                                               msg=f"{n} ({when}) at {r['coords']}")
                else:
                    assert torch.equal(got[n], exp[n]), (n, when, r["coords"])
    if ranks[0]["block"] is not None:
        held = [(r["coords"]["data"], r["cache_values"][1]) for r in ranks]
        tags = {d: next(v for n, v in vals.items() if n.endswith("kv_pos")) for d, vals in held}
        if name == "mixtral_8x7b_empty_block_2x2":
            assert (tags[1] == -1).all() and (tags[0] >= 0).any()   # rank 1 saw no key
        if name == "mixtral_8x7b_ring_2x2":       # the query's slots and older ones on rank 0
            newest = int(tags[0].max())
            assert newest == 80 + DECODES - 1 and int(tags[0][0, 0, -1]) < 64


def _visible_by_runs(p, S, D, window):
    """{rank: the positions its K2 launches of ``block_runs`` read} for a
    query at p, from a ring (or linear row) of S slots written in order."""
    held = {}
    for d in range(D):
        block = transformer.SeqBlock(d, D, S)
        seen = []
        for rows, firsts, lens, w in transformer.block_runs([p], block, window):
            assert rows == [0]
            base = block.lo + firsts[0] * transformer.PAGE_SIZE
            for i in range(lens[0]):
                if w is not None and i < lens[0] - w:
                    continue
                s = base + i
                q = p - ((p - s) % S)           # the position slot s holds
                assert q >= 0, (p, d, s)
                seen.append(q)
        held[d] = seen
    return held


@pytest.mark.parametrize("S,D,window", [(64, 2, 64), (64, 4, 64), (64, 2, 48), (64, 2, None),
                                        (128, 4, 80)])
def test_block_runs_read_each_visible_key_once(S, D, window):
    """Over every query position (past several wraps of a ring; up to the
    row's end for a linear one), the keys the ranks' launches read are the
    window's p − window + 1 .. p (all of 0 .. p without one), each on one
    rank, once; no rank launches more than two runs."""
    last = 5 * S if window else S
    for p in range(last):
        held = _visible_by_runs(p, S, D, window)
        seen = sorted(q for qs in held.values() for q in qs)
        lo = 0 if window is None else max(0, p - window + 1)
        assert seen == list(range(lo, p + 1)), (p, held)
        assert all(len(transformer.block_runs([p], transformer.SeqBlock(d, D, S), window)) <= 2
                   for d in range(D))


def _in_process(cfg, names, sizes, coords, B, cache_size, **kw):
    model = build_model(cfg)
    fake = _Coords(names, sizes, coords)
    with mesh.use_mesh(fake):
        return model.init_cache(B, cache_size, torch.float32, "meta", **kw)


def test_what_context_parallelism_does_not_run_raises():
    """A block of the KV sequence that is not a whole number of K2's
    pages raises, naming the leaf: 64 linear slots over 8 "data" ranks.  A
    block of the frames need not be: whisper's 1500 frames over 4 "model"
    ranks under ``kv_seq_shard`` give 375 a rank, as the reference's rule
    cuts them, stored in 384 slots.  ``kv_append="defer"`` and an
    encoder-decoder's cross cache, which raised until context parallelism
    ran them (tests/test_torch_defer_mesh.py), build with their blocks;
    an encoder-decoder's rows over "data" build as before."""
    coords = {"data": 1, "model": 0}
    with pytest.raises(ValueError, match="layers/k.*whole number of K2's pages"):
        _in_process(get_reduced_config("llama3_8b"), DM, (8, 1), coords, 1, 64)
    small = get_reduced_config("whisper_base")
    whisper = small.replace(encoder=dataclasses.replace(small.encoder, max_source_positions=1500))
    quarter = _in_process(whisper, DM, (1, 4), {"data": 0, "model": 1}, 4, 64, seq_shard=True)
    assert quarter["cross_block"] == transformer.SeqBlock(1, 4, 1500, "model")
    assert (quarter["cross_block"].lo, quarter["cross_block"].span) == (375, 375)
    assert quarter["cross_k"].shape[2] == 384 and quarter["cross_frames"] == 1500
    defer = _in_process(get_reduced_config("llama3_8b").replace(kv_append="defer"), DM, (2, 1),
                        coords, 1, 64)
    assert defer["seq_block"] == transformer.SeqBlock(1, 2, 64)
    cross = _in_process(get_reduced_config("whisper_base"), DM, (2, 1), coords, 1, 64,
                        enc_frames=32)
    assert cross["cross_block"] == transformer.SeqBlock(1, 2, 32)
    assert cross["cross_k"].shape[2] == 16 and cross["seq_block"].whole == 64
    rows = _in_process(get_reduced_config("whisper_base"), DM, (2, 1), coords, 4, 64,
                       enc_frames=32)
    assert rows["cross_k"].shape[1] == 2 and "seq_block" not in rows


@pytest.mark.parametrize("argv", [
    ["--arch", "mixtral_8x7b", "--mesh", "2,2", "--batch", "1", "--prompt", "80"],
    ["--arch", "qwen3_30b_a3b", "--mesh", "2,1,2", "--batch", "2", "--prompt", "24"]])
def test_launcher_on_a_mesh_of_cpu_ranks(argv):
    """``launch.parallel --mesh`` as its CPU rehearsal runs it (phases 33 and
    34 at reduced size): each rank's blocks and cache by the rules at the
    mesh (``check``), its rows' or every row's logits of a prefill and 3
    decodes within 2e-4 of the one-process model's, the bytes of the
    experts' d gathered (every expert's block in the prefill, at most that
    in a decode) and the blocks' attention merged at batch 1."""
    from repro_torch.launch import parallel
    args = parallel.parse_args(argv + ["--reduced", "--device", "cpu", "--dtype", "float32",
                                       "--decodes", "3"])
    ranks, ref = parallel.launch(args), parallel.reference(args)
    assert not any(parallel.check(args, ranks, ref, 2e-4).values())   # no kernel on the CPU
    # the prefill's tokens choose every expert, a decode's a few: only
    # those are gathered
    block = sum(int(np.prod(s)) * 4 for n, s in ranks[0]["params"].items()
                if n.endswith(("moe/w_in", "moe/w_out")))
    assert ranks[0]["prefill"][0]["gathered"]["experts"] == block
    for r in ranks:
        assert all(step.get("experts", 0) <= block for step in r["decode"]["gathered"])
        assert all(("merge" in step) == (args.batch == 1) for step in r["decode"]["gathered"])
    lines = parallel.summary(ranks, ref)
    assert len(lines) == 2 and "experts" in lines[1]
