"""The machinery of ``tests/test_torch_seq_shard.py`` and
``tests/test_torch_defer_mesh.py``: context-parallel serving cases in gloo
groups of CPU processes of ``tests/_torch_serve_mesh_worker.py``, the
one-process port model and the JAX model (jitted) on the same weights and
tokens, and the checks both files run on each case.

A case is (arch, mesh names, mesh sizes, batch, prefill chunks, cache
size, knobs): ``seq_shard`` (the reference's ``kv_seq_shard``), ``defer``
(``kv_append="defer"``) and ``frames`` (an encoder-decoder's frame
embeddings a row, given with the first chunk).  The weights are the
port's from seed 43, copied into the JAX model's tree by name and cut into
the ranks' blocks (``launch.mesh.shard_params``); the tokens and frames
come from numpy seed 43.
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.launch import mesh as jmesh
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_reduced_config
from repro_torch.launch import mesh
from repro_torch.models import transformer
from repro_torch.models.transformer import SeqBlock, build_model
from test_torch_serve_mesh import REPO, WORKER, _Coords, _env

DECODES = 3
DM = ("data", "model")
SS, DEFER = {"seq_shard": True}, {"defer": True}


def world(spec) -> int:
    return int(np.prod(spec[2]))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(the JAX model's tree, the port's) of the reduced config's weights:
    the port's from seed 43 (drawn in milliseconds, where the JAX model's
    own init takes seconds a config), copied into the JAX tree by name."""
    params = build_model(get_reduced_config(arch)).init(torch.Generator().manual_seed(43),
                                                        torch.float32, "cpu")
    named = dict(mesh.leaves_with_names(params))
    tree = jax_build_model(jax_reduced_config(arch)).abstract_params(jnp.float32)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(named[jmesh._leaf_name(path)].numpy()), tree)
    return jp, params


def build_case(spec):
    """(the worker's case, a function that returns the JAX logits at each
    step), the JAX model being run only when it is called."""
    arch, names, sizes, B, chunks, cache_size, knobs = spec
    append = "defer" if knobs.get("defer") else "inline"
    jcfg = jax_reduced_config(arch).replace(kv_append=append)
    jm = jax_build_model(jcfg)
    jp, params = _params(arch)
    rng = np.random.default_rng(43)
    prompt = rng.integers(0, jcfg.vocab_size, (B, sum(chunks)))
    fed = rng.integers(0, jcfg.vocab_size, (DECODES, B, 1))
    F = knobs.get("frames")
    frames = None if F is None else rng.standard_normal((B, F, jcfg.d_model)).astype(np.float32)

    def jax_logits():
        # jitted: eager dispatch would take most of the files' time, and the
        # 2e-3 comparison does not see XLA's fusions
        prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
        if F is None:
            # the JAX ring holds the whole context, so that a chunk may outrun it
            cache = jm.init_cache(B, cache_size, jnp.float32, window_slack=cache_size)
        else:
            cache = jm.init_cache(B, cache_size, jnp.float32, enc_frames=F)
        out, s0 = [], 0
        for n in chunks:
            inputs = {"tokens": jnp.asarray(prompt[:, s0:s0 + n])}
            if frames is not None and s0 == 0:
                inputs["frontend_embeds"] = jnp.asarray(frames)
            logits, cache = prefill(jp, inputs, cache)
            out.append(np.asarray(logits))
            s0 += n
        for t in range(DECODES):
            logits, cache = decode(jp, cache, jnp.asarray(fed[t]))
            out.append(np.asarray(logits))
        return out

    case = {"cfg": get_reduced_config(arch).replace(kv_append=append), "mesh": (names, sizes),
            "params": params,
            "prompt": torch.from_numpy(prompt), "chunks": list(chunks),
            "fed": torch.from_numpy(fed), "cache_size": cache_size,
            "seq_shard": knobs.get("seq_shard", False),
            "frames": None if frames is None else torch.from_numpy(frames)}
    return case, jax_logits


def _init_cache(case, device):
    model = build_model(case["cfg"])
    frames = case["frames"]
    extra = {} if frames is None else {"enc_frames": frames.shape[1]}
    return model, model.init_cache(case["prompt"].shape[0], case["cache_size"], torch.float32,
                                   device, **extra)


def one_process(case):
    """(logits at each step, the cache's values after the prefill and after
    the decodes) of the one-process port model on the whole batch."""
    model, cache = _init_cache(case, "cpu")
    frames = case["frames"]
    rows = torch.arange(case["prompt"].shape[0])
    logits, kept, s0 = [], [], 0
    with torch.no_grad():
        for n in case["chunks"]:
            inputs = {"tokens": case["prompt"][:, s0:s0 + n]}
            if frames is not None and s0 == 0:
                inputs["frontend_embeds"] = frames
            logits.append(model.prefill(case["params"], inputs, cache)[0])
            s0 += n
        kept.append({k: v.clone() for k, v in mesh.leaves_with_names(cache)})
        for t in range(DECODES):
            logits.append(model.decode_slots(case["params"], cache, case["fed"][t], rows))
        kept.append(dict(mesh.leaves_with_names(cache)))
    return logits, kept


def run_groups(tmp, specs):
    """{case name: (its worker case, the ranks' results, the one-process
    logits and cache values, JAX logits)} of ``specs`` ({name: case}): one
    group of ranks for each world size, all at once, while the JAX model
    runs here."""
    built = {name: build_case(spec) for name, spec in specs.items()}
    started = {}
    for w in sorted({world(s) for s in specs.values()}):
        path = tmp / f"cases{w}.pt"
        torch.save({n: built[n][0] for n, s in specs.items() if world(s) == w}, path)
        out = tmp / f"world{w}"
        out.mkdir()
        started[w] = out, [subprocess.Popen(
            [sys.executable, str(WORKER), str(w), str(r), str(tmp / f"store{w}"),
             str(out), str(path)], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(w)]
    jlogits = {name: built[name][1]() for name in specs}
    ranks = {}
    for w, (out, procs) in started.items():
        errors = []
        for p in procs:
            _, err = p.communicate(timeout=240)
            if p.returncode:
                errors.append(err[-3000:])
        assert not errors, "\n".join(errors)
        ranks[w] = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(w)]
    return {name: (built[name][0], [r[name] for r in ranks[world(spec)]],
                   one_process(built[name][0]), jlogits[name]) for name, spec in specs.items()}


def check_logits(entry):
    """Every rank's logits after each prefill chunk and each decode within
    2e-4 of the one-process port model's and 2e-3 of the JAX model's; the
    ranks that serve the same rows agree exactly."""
    case, ranks, (one, _), jlogits = entry
    assert len(one) == len(jlogits) == len(case["chunks"]) + DECODES
    for r in ranks:
        rows = slice(*r["rows"])
        assert len(r["logits"]) == len(one)
        for step, (got, exp, jexp) in enumerate(zip(r["logits"], one, jlogits)):
            torch.testing.assert_close(got, exp[rows], rtol=2e-4, atol=2e-4,
                                       msg=f"rank coords {r['coords']} step {step}")
            np.testing.assert_allclose(got.numpy(), jexp[rows], rtol=2e-3, atol=2e-3,
                                       err_msg=f"rank coords {r['coords']} step {step}")
    for r in ranks[1:]:
        same = [q for q in ranks if q["rows"] == r["rows"]]
        for step in range(len(one)):
            assert torch.equal(r["logits"][step], same[0]["logits"][step])


def check_blocks(entry):
    """Each rank's cache shapes are ``shard_shape`` of the rules in force
    (``kv_seq_shard`` included), an encoder-decoder's block of the frames
    at the reference's frame count, F / n, stored in whole pages of K2
    (``mesh.cache_shapes``); it holds the block of the KV sequence and of
    the frames the rules place (over "model" where the batch axes divide
    the batch under ``kv_seq_shard``, with every KV head whole; over "data"
    where they do not), and the exchange over that axis ran under its name:
    "seq_shard" over "model", "merge" over "data"."""
    case, ranks, _, _ = entry
    names, sizes = case["mesh"]
    axes = mesh.MeshAxes(names, sizes)
    B, seq_shard = case["prompt"].shape[0], case["seq_shard"]
    _, whole = _init_cache(case, "meta")
    spec_of = mesh.named_specs(mesh.cache_specs(whole, axes, batch=B, seq_shard=seq_shard))
    expect = {n: mesh.shard_shape(tuple(leaf.shape), spec_of[n], axes)
              for n, leaf in mesh.leaves_with_names(whole)}
    model_axis = seq_shard and B % sizes[0] == 0
    axis = "model" if model_axis else "data"
    n_axis = sizes[names.index(axis)]
    if case["frames"] is not None:
        F = case["frames"].shape[1]
        span = F // n_axis
        for leaf in ("cross_k", "cross_v"):
            expect[leaf] = expect[leaf][:2] + (transformer.whole_pages(span),) + expect[leaf][3:]
        assert mesh.cache_shapes(whole, axes, batch=B, seq_shard=seq_shard) == expect
    for r in ranks:
        assert r["cache"] == expect
        for key, leaf in (("block", "k"), ("cross_block", "cross_k")):
            if key == "cross_block" and case["frames"] is None:
                assert r[key] is None
                continue
            S = F if key == "cross_block" else next(
                t.shape[-3] for nm, t in mesh.leaves_with_names(whole)
                if nm.rsplit("/", 1)[-1] == leaf)
            assert r[key] == SeqBlock(r["coords"][axis], n_axis, S, axis), (key, r["coords"])
            assert (r[key].lo, r[key].span) == (r["coords"][axis] * S // n_axis, S // n_axis)
        if model_axis:
            kv = next(s for nm, s in r["cache"].items() if nm.rsplit("/", 1)[-1] == "k")
            assert kv[-2] == case["cfg"].num_kv_heads and r["gathered"]["seq_shard"] > 0
            assert "merge" not in r["gathered"]
        else:
            assert r["gathered"]["merge"] > 0 and "seq_shard" not in r["gathered"]


def check_cache(entry):
    """After the prefill and after the decodes, each rank's cache is its
    block of the one-process cache by the rules in force
    (``mesh.shard_cache``): its rows and its slots of each row's K, V and
    ``kv_pos`` (the tags exactly), every KV head where "model" cuts the
    slots, and its block of the frames (frames i·F / n .. (i + 1)·F / n of
    the one-process row, the block's pad excluded, and zero); under the
    deferred append too, where each rank writes only the positions whose
    slots it holds."""
    case, ranks, (_, kept), _ = entry
    names, sizes = case["mesh"]
    B = case["prompt"].shape[0]
    for r in ranks:
        fake = _Coords(names, sizes, r["coords"])
        xb = r["cross_block"]
        for when, (got, whole) in enumerate(zip(r["cache_values"], kept)):
            whole = dict(whole)
            if case["frames"] is not None:
                whole["cross_frames"] = case["frames"].shape[1]
            exp = dict(mesh.leaves_with_names(mesh.shard_cache(
                whole, fake, batch=B, seq_shard=case["seq_shard"])))
            assert got.keys() == exp.keys()
            got = dict(got)
            for n in ("cross_k", "cross_v") if xb is not None else ():
                assert not got[n][:, :, xb.span:].any(), (n, when, r["coords"])
                got[n], exp[n] = got[n][:, :, :xb.span], exp[n][:, :, :xb.span]
                torch.testing.assert_close(exp[n], kept[when][n][:, :, xb.lo:xb.hi], rtol=0,
                                           atol=0)
            for n in exp:
                if got[n].dtype.is_floating_point:
                    torch.testing.assert_close(got[n], exp[n], rtol=1e-4, atol=1e-4,
                                               msg=f"{n} ({when}) at {r['coords']}")
                else:
                    assert torch.equal(got[n], exp[n]), (n, when, r["coords"])


def stale_runs_read(p, S, D, window):
    """{rank: the positions its K2 launches of ``block_runs(...,
    deferred=True)`` read} for a query at p, of a ring (or linear row) of S
    slots written in order up to p − 1."""
    held = {}
    for d in range(D):
        block = SeqBlock(d, D, S)
        seen = []
        for rows, firsts, lens, w in transformer.block_runs([p], block, window, deferred=True):
            assert rows == [0]
            base = block.lo + firsts[0] * transformer.PAGE_SIZE
            for i in range(lens[0]):
                if w is not None and i < lens[0] - w:
                    continue
                s = base + i
                q = (p - 1) - ((p - 1 - s) % S)        # the position slot s holds
                assert 0 <= q < p, (p, d, s)
                seen.append(q)
        held[d] = seen
    return held


def check_launcher(argv):
    """``launch.parallel`` at reduced size on CPU ranks: each rank's blocks
    and cache by the rules in force (``check``), the logits of a prefill
    and 3 decodes within 2e-4 of the one-process model's, the exchange
    counted under its name ("seq_shard" under ``kv_seq_shard``, "merge"
    over "data"), the same bytes at every decode."""
    from repro_torch.launch import parallel
    args = parallel.parse_args(argv + ["--reduced", "--device", "cpu", "--dtype", "float32",
                                       "--decodes", "3"])
    ranks, ref = parallel.launch(args), parallel.reference(args)
    assert not any(parallel.check(args, ranks, ref, 2e-4).values())   # no kernel on the CPU
    key = "seq_shard" if parallel.seq_shard(args) else "merge"
    for r in ranks:
        steps = [step[key] for step in r["decode"]["gathered"]]
        assert steps[0] > 0 and len(set(steps)) == 1, steps
    assert key in parallel.summary(ranks, ref)[-1]
