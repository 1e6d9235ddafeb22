"""Tensor parallelism where the serve rules fall back from heads to head_dim,
the encoder-decoder and the RG-LRU's width, in gloo groups of CPU
processes, against the one-process port model and the JAX model.

Each group is 2 or 4 processes of ``tests/_torch_tp_worker.py`` that meet
through a ``FileStore`` under the test's temporary directory, started as
``tests/test_torch_tensor_parallel.py`` starts them.  The weights
are the JAX model's (``jax.random.key(41)``), through the bridge and the
ranks' cut (``launch.mesh.shard_params``).  The cases:

* reduced ``llama3_70b`` at tp 4: 4 query heads over 2 KV heads of 16, so a
  rank holds one query head and a 4-wide block of head_dim of both KV heads
  (q and o on heads, k and v on head_dim; RoPE on the gathered heads), also
  with ``kv_append="defer"``; both prefill in two chunks, so the second
  reads the cached prefix gathered to whole heads;
* reduced ``qwen2_5_3b`` at tp 4: the same heads, QKV biases (a head_dim
  block of ``bk``/``bv``) and tied embeddings;
* 6 query heads over 2 KV heads at tp 4: no head count splits, so every
  projection is on head_dim and each rank attends for every query head;
* reduced ``recurrentgemma_2b`` at tp 2 with a 104-token prompt past its
  64-token window: 2 query heads a rank over a half of its one KV head, the
  ring on head_dim blocks, the RG-LRU on half its width; it prefills in
  chunks of 48, 32 and 24, so the second crosses the ring's end and the
  third reads the ring's earlier rows in two ranges, each gathered;
* reduced ``whisper_base`` at tp 2 with 32 frames (encoder, decoder and
  cross attention on heads), and with 6 heads at tp 4 (all on head_dim).

Each checks that every leaf of a rank's parameters and cache has the shape
``shard_shape`` gives its serve placement, and that the logits of each
prefill chunk and of 3 decodes through ``decode_slots`` lie within 2e-4 of the
one-process port model's (fp32) and within 2e-3 of the JAX model's at
every step, the same on every rank.  A walk over the 13 full configs on the
meta device at 2, 4, 8 and 16 ranks holds ``model_placements`` to the serve
rules: every leaf is placed as the rules place it (the SSD's leaves and an
MoE's experts on their FFN width included), and a leaf that no layer runs
raises.  The launcher (``repro_torch.launch.parallel``) serves reduced
qwen2_5_3b and mamba2_370m on 4 CPU ranks and recurrentgemma_2b and
whisper_base (with frames) on 2, as phases 26-29 do on the card, against
its one-process model (``parallel.check``).
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

DECODES = 3
# name: (arch, config overrides, tp, prefill chunks, cache size, frames, JAX window slack)
CASES = {
    "llama3_70b": ("llama3_70b", {}, 4, (16, 8), 48, 0, 0),
    "llama3_70b_defer": ("llama3_70b", {"kv_append": "defer"}, 4, (16, 8), 48, 0, 0),
    "qwen2_5_3b": ("qwen2_5_3b", {}, 4, (24,), 48, 0, 0),
    "six_query_heads": ("llama3_70b", {"num_heads": 6, "num_kv_heads": 2}, 4, (24,), 48, 0, 0),
    "recurrentgemma_2b": ("recurrentgemma_2b", {}, 2, (48, 32, 24), 96, 0, 32),
    "whisper_base": ("whisper_base", {}, 2, (12,), 32, 32, 0),
    "whisper_base_six_heads": ("whisper_base", {"num_heads": 6, "num_kv_heads": 6}, 4, (12,),
                               32, 32, 0),
}
# (wq, wk, wv, wo) placements of each case's attention (model_placements)
SPLIT = {"llama3_70b": (-2, -1, -1, -3), "llama3_70b_defer": (-2, -1, -1, -3),
         "qwen2_5_3b": (-2, -1, -1, -3), "six_query_heads": (-1, -1, -1, -2),
         "recurrentgemma_2b": (-2, -1, -1, -3), "whisper_base": (-2, -2, -2, -3),
         "whisper_base_six_heads": (-1, -1, -1, -2)}
ARCHS = ["dbrx_132b", "granite_3_8b", "granite_8b", "llama3_70b", "llama3_8b",
         "llava_next_mistral_7b", "mamba2_370m", "mixtral_8x7b", "olmo_1b", "qwen2_5_3b",
         "qwen3_30b_a3b", "recurrentgemma_2b", "whisper_base"]


def _case(name):
    """(port config, whole port params, the worker's inputs, JAX logits at
    each step)."""
    arch, overrides, _, chunks, cache_size, frames, slack = CASES[name]
    jcfg = jax_reduced_config(arch).replace(**overrides)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(41), jnp.float32)
    # jitted: eagerly, the JAX model took most of the file's time; the 2e-3
    # comparison does not see XLA's fusions
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    rng = np.random.default_rng(41)
    prompt = rng.integers(0, jcfg.vocab_size, (2, sum(chunks)))
    fed = rng.integers(0, jcfg.vocab_size, (DECODES, 2, 1))
    inputs = {}
    if frames:
        fe = rng.standard_normal((2, frames, jcfg.d_model)).astype(np.float32)
        inputs["frontend_embeds"] = jnp.asarray(fe)
        cache = jm.init_cache(2, cache_size, jnp.float32, enc_frames=frames)
    else:
        cache = jm.init_cache(2, cache_size, jnp.float32, window_slack=slack)
    jlogits, s0 = [], 0
    for n in chunks:
        inputs["tokens"] = jnp.asarray(prompt[:, s0:s0 + n])
        logits, cache = prefill(jp, inputs, cache)
        jlogits.append(np.asarray(logits))
        inputs.pop("frontend_embeds", None)
        s0 += n
    for t in range(DECODES):
        logits, cache = decode(jp, cache, jnp.asarray(fed[t]))
        jlogits.append(np.asarray(logits))
    cfg = get_reduced_config(arch).replace(**overrides)
    params = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    case = {"cfg": cfg, "params": params, "prompt": torch.from_numpy(prompt),
            "chunks": list(chunks), "fed": torch.from_numpy(fed), "cache_size": cache_size}
    if frames:
        case["frames"] = torch.from_numpy(fe)
    return case, jlogits


def _one_process(case):
    model = build_model(case["cfg"])
    inputs, extra = {}, {}
    if "frames" in case:
        inputs["frontend_embeds"] = case["frames"]
        extra["enc_frames"] = case["frames"].shape[1]
    cache = model.init_cache(2, case["cache_size"], torch.float32, "cpu", **extra)
    rows = torch.arange(2)
    logits, s0 = [], 0
    with torch.no_grad():
        for n in case["chunks"]:
            inputs["tokens"] = case["prompt"][:, s0:s0 + n]
            logits.append(model.prefill(case["params"], inputs, cache)[0])
            inputs.pop("frontend_embeds", None)
            s0 += n
        for t in range(DECODES):
            logits.append(model.decode_slots(case["params"], cache, case["fed"][t], rows))
    return logits


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{case name: (its worker case, the ranks' results, one-process logits,
    JAX logits)}: the groups of 2 and 4 ranks run at once."""
    tmp = tmp_path_factory.mktemp("tp_fallback")
    built = {name: _case(name) for name in CASES}
    started = {}
    for world in sorted({c[2] for c in CASES.values()}):
        cases = {name: built[name][0] for name, c in CASES.items() if c[2] == world}
        started[world] = _start(world, tmp, cases)
    ranks = {world: _wait(world, *started[world]) for world in started}
    return {name: (built[name][0], [r[name] for r in ranks[CASES[name][2]]],
                   _one_process(built[name][0]), built[name][1])
            for name in CASES}


def _expected_shapes(cfg, tp, cache_size, frames):
    """{"params", "cache"}: {leaf: shard_shape of its serve placement} at a
    (1, tp) mesh, from the whole trees on the meta device."""
    axes = mesh.MeshAxes(("data", "model"), (1, tp))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, "meta")
    extra = {"enc_frames": frames} if frames else {}
    cache = model.init_cache(2, cache_size, torch.float32, "meta", **extra)
    out = {}
    for what, tree, specs in (("params", params, mesh.param_specs(params, axes, "serve")),
                              ("cache", cache, mesh.cache_specs(cache, axes, batch=2))):
        spec_of = mesh.named_specs(specs)
        out[what] = {n: mesh.shard_shape(tuple(leaf.shape), spec_of[n], axes)
                     for n, leaf in mesh.leaves_with_names(tree)}
    return out, mesh.model_placements(params, tp)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_blocks_are_the_rules_blocks(groups, name):
    case, ranks, _, _ = groups[name]
    cfg, tp = case["cfg"], CASES[name][2]
    expect, dims = _expected_shapes(cfg, tp, case["cache_size"], CASES[name][5])
    for r in ranks:
        assert r["params"] == expect["params"]
        assert r["cache"] == expect["cache"]
    for prefix in {n.rsplit("attn/", 1)[0] for n in dims if n.endswith("attn/wq")}:
        assert tuple(dims[f"{prefix}attn/{w}"] for w in ("wq", "wk", "wv", "wo")) == SPLIT[name]
    q, k, _, _ = SPLIT[name]
    wq, wk = (next(shape for n, shape in sorted(ranks[0]["params"].items()) if n.endswith(leaf))
              for leaf in ("attn/wq", "attn/wk"))
    assert wq[-2:] == ((cfg.num_heads // tp, cfg.head_dim) if q == -2
                       else (cfg.num_heads, cfg.head_dim // tp))
    assert wk[-2:] == ((cfg.num_kv_heads // tp, cfg.head_dim) if k == -2
                       else (cfg.num_kv_heads, cfg.head_dim // tp))
    if cfg.rglru is not None:
        assert ranks[0]["cache"]["layers/0/state"][-1] == cfg.rglru.lru_width // tp


@pytest.mark.parametrize("name", list(CASES))
def test_rank_logits_match_one_process_and_jax(groups, name):
    case, ranks, one, jlogits = groups[name]
    assert len(ranks[0]["logits"]) == len(one) == len(jlogits) == len(CASES[name][3]) + DECODES
    for step, (got, exp, jexp) in enumerate(zip(ranks[0]["logits"], one, jlogits)):
        torch.testing.assert_close(got, exp, rtol=2e-4, atol=2e-4, msg=f"step {step}")
        np.testing.assert_allclose(got.numpy(), jexp, rtol=2e-3, atol=2e-3,
                                   err_msg=f"step {step}")
        for r in ranks[1:]:
            assert torch.equal(r["logits"][step], got)
    # head_dim blocks cross "model"; the RG-LRU's conv'd input is gathered
    assert (ranks[0]["gathered"].get("head_dim", 0) > 0) == (-1 in SPLIT[name])
    assert (ranks[0]["gathered"].get("rglru", 0) > 0) == (case["cfg"].rglru is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_placements_follow_the_rules(arch):
    """Every full config on the meta device (one layer of a uniform stack)
    at 2, 4, 8 and 16 "model" ranks: each leaf's placement is the serve
    rules' dimension, none kept whole against them (the SSD's packed
    ``w_in`` and its ``w_out``, mixtral's experts on their FFN width at 16
    ranks); one more leaf that the rules place and no layer runs raises,
    naming it.  A rank's cache from its blocks has the rules' blocks of
    every leaf, an SSD's state and conv state included."""
    cfg = get_config(arch)
    if len(set(cfg.layer_pattern)) == 1:
        cfg = cfg.replace(num_layers=1, layer_pattern=None)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16, "meta")
    names = dict(mesh.leaves_with_names(params))
    unrun = {**params, "unrun": {"w_x": torch.empty((cfg.d_model, 256), device="meta")}}
    for tp in (2, 4, 8, 16):
        axes = mesh.MeshAxes(("data", "model"), (1, tp))
        with pytest.raises(ValueError, match="unrun/w_x .* no layer of the port runs"):
            mesh.model_placements(unrun, tp)
        dims = mesh.model_placements(params, tp)
        ruled = {n: mesh._model_dim(mesh._param_spec(n, tuple(leaf.shape), axes, "serve"),
                                    leaf.dim()) for n, leaf in names.items()}
        assert dims == ruled
        if cfg.ssm is not None:
            assert dims["blocks/ssd/w_in"] == -1 and dims["blocks/ssd/w_out"] == -2
        if arch == "mixtral_8x7b":
            assert dims["blocks/moe/w_in"] == (-1 if tp == 16 else -3)
        rank = mesh.shard_params(params, _FakeMesh(tp - 1, tp))
        extra = {"enc_frames": 16} if cfg.is_enc_dec else {}
        cache = model.init_cache(2, 16, torch.bfloat16, "meta", params=rank, **extra)
        whole = model.init_cache(2, 16, torch.bfloat16, "meta", **extra)
        spec_of = mesh.named_specs(mesh.cache_specs(whole, axes, batch=2))
        for n, leaf in mesh.leaves_with_names(whole):
            got = tuple(dict(mesh.leaves_with_names(cache))[n].shape)
            assert got == mesh.shard_shape(tuple(leaf.shape), spec_of[n], axes), (tp, n)


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2_5_3b", "--ranks", "4", "--prompt", "24"],
    ["--arch", "recurrentgemma_2b", "--ranks", "2", "--prompt", "80"],
    ["--arch", "whisper_base", "--ranks", "2", "--prompt", "12", "--frames", "32"],
    ["--arch", "mamba2_370m", "--ranks", "4", "--prompt", "40"]])
def test_launcher_on_cpu_ranks(argv):
    """``launch.parallel`` as its CPU rehearsal runs these archs (phases
    26-29 at reduced size): each rank's blocks and cache by the rules
    (``check``, whisper's cross cache and mamba2's SSD states among them),
    the logits of a prefill (after random frames for whisper) and 3 decodes
    within 2e-4 of the one-process model's, and the bytes each step
    gathered where a block of head_dim, of the RG-LRU's width or of the
    SSD's packed columns crosses "model"."""
    from repro_torch.launch import parallel
    args = parallel.parse_args(argv + ["--reduced", "--device", "cpu", "--dtype", "float32",
                                       "--batch", "2", "--decodes", "3"])
    ranks, ref = parallel.launch(args), parallel.reference(args)
    assert not any(parallel.check(args, ranks, ref, 2e-4).values())   # no kernel on the CPU
    gathered = ranks[0]["prefill"][0]["gathered"]
    assert set(gathered) == {"qwen2_5_3b": {"head_dim"}, "recurrentgemma_2b": {"head_dim", "rglru"},
                             "whisper_base": set(), "mamba2_370m": {"ssd"}}[args.arch]
    assert all(step == ranks[0]["decode"]["gathered"][0] for step in ranks[0]["decode"]["gathered"])
    if args.frames:
        assert ranks[0]["cache"]["cross_k"][2:] == (32, 2, 16)           # 2 of 4 heads a rank
    assert len(parallel.summary(ranks, ref)) == 2
