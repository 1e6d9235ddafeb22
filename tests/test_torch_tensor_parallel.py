"""Tensor parallelism over "model" ranks (Megatron's split of the dense layers)
in gloo groups of CPU processes, against the one-process port model and the
JAX model.

Each group is 2 or 4 processes of ``tests/_torch_tp_worker.py`` that meet
through a ``FileStore`` under the test's temporary directory; every child
gets ``PYTHONDONTWRITEBYTECODE=1`` and caps torch at 2 threads.  The weights
are the JAX model's (``jax.random.key(41)``), through the bridge and the
ranks' cut (``launch.mesh.shard_params``).

* Reduced ``llama3_70b`` (4 query heads over 2 KV heads) and reduced
  ``qwen2_5_3b`` (the same heads, QKV biases, tied embeddings) at tp 2, and
  a llama3_70b-shaped config of 8 query heads over 4 KV heads at tp 4: each
  rank's leaves and cache have the shapes ``shard_shape`` gives their serve
  placements, and the logits of a 24-token prefill of two rows and of 3
  decodes through ``decode_slots`` lie within 2e-4 of the one-process port
  model's (fp32) and within 2e-3 of the JAX model's at every step; the
  ranks' logits are the same.
* ``build_params`` gives each rank the blocks ``shard_params`` cuts from the
  whole tree that ``model.init`` draws from the same seed.
* A placement the port does not run raises a ``ValueError`` that names the
  leaf, in ``shard_params`` and ``build_params``: a leaf under the SSD that
  no layer runs (the heads' fallback to head_dim, the RG-LRU and the
  encoder-decoder run since, in ``tests/test_torch_tp_fallback.py``; the
  SSD's own leaves and the experts' FFN width in
  ``tests/test_torch_tp_packed.py``).  An MoE tree splits its attention as
  the rules do and its experts on the expert axis, or on their FFN width
  where they do not divide (full qwen3_30b_a3b, mixtral_8x7b and dbrx_132b
  on the meta device), and the cache takes its KV heads and head_dim from
  the weights.
* The launcher (``repro_torch.launch.parallel``) on 4 CPU ranks: the
  8-over-4-head config, its ranks against its one-process model
  (``parallel.check`` at 2e-4: shapes, logits at every step).
"""

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
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import mesh
from repro_torch.models.convert import from_numpy
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)    # the suite runs in several workers at once

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_tp_worker.py"
CACHE = 48
# name: (arch, config overrides, tp)
CASES = {"llama3_70b": ("llama3_70b", {}, 2),
         "qwen2_5_3b": ("qwen2_5_3b", {}, 2),
         "llama3_70b_8x4": ("llama3_70b", {"num_heads": 8, "num_kv_heads": 4}, 4)}


def _case(name):
    """(port config, whole port params, prompt, fed, JAX logits at each step)."""
    arch, overrides, _ = CASES[name]
    jcfg = jax_reduced_config(arch).replace(**overrides)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(41), jnp.float32)
    rng = np.random.default_rng(41)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 24))
    fed = rng.integers(0, jcfg.vocab_size, (3, 2, 1))
    cache = jm.init_cache(2, CACHE, jnp.float32)
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, cache)
    jlogits = [np.asarray(logits)]
    for t in range(3):
        logits, cache = jm.decode_step(jp, cache, jnp.asarray(fed[t]))
        jlogits.append(np.asarray(logits))
    cfg = get_reduced_config(arch).replace(**overrides)
    params = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, params, torch.from_numpy(prompt), torch.from_numpy(fed), jlogits


def _one_process(cfg, params, prompt, fed):
    model = build_model(cfg)
    cache = model.init_cache(2, CACHE, torch.float32, "cpu")
    rows = torch.arange(2)
    with torch.no_grad():
        logits = [model.prefill(params, {"tokens": prompt}, cache)[0]]
        for t in range(fed.shape[0]):
            logits.append(model.decode_slots(params, cache, fed[t], rows))
    return logits


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), PYTHONDONTWRITEBYTECODE="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    return env


def _start(world, tmp, cases):
    out = tmp / f"world{world}"
    out.mkdir()
    path = tmp / f"cases{world}.pt"
    torch.save(cases, path)
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(world), str(r),
                               str(tmp / f"store{world}"), str(out), str(path)], env=_env(),
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    return out, procs


def _wait(world, out, procs):
    errors = []
    for p in procs:
        _, err = p.communicate(timeout=240)
        if p.returncode:
            errors.append(err[-3000:])
    assert not errors, "\n".join(errors)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{case name: (its config, the ranks' results, one-process logits, JAX
    logits)}: the groups of 2 and 4 ranks run at once."""
    tmp = tmp_path_factory.mktemp("tp")
    built = {name: _case(name) for name in CASES}
    started = {}
    for world in sorted({tp for _, _, tp in CASES.values()}):
        cases = {name: {"cfg": built[name][0], "params": built[name][1],
                        "prompt": built[name][2], "fed": built[name][3], "cache_size": CACHE}
                 for name, (_, _, tp) in CASES.items() if tp == world}
        started[world] = _start(world, tmp, cases)
    ranks = {world: _wait(world, *started[world]) for world in started}
    return {name: (built[name][0], [r[name] for r in ranks[CASES[name][2]]],
                   _one_process(*built[name][:4]), built[name][4])
            for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_rank_blocks_are_their_placements(groups, name):
    cfg, ranks, _, _ = groups[name]
    tp = CASES[name][2]
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
    split = ranks[0]["params"]
    assert split["blocks/attn/wq"][-2] == cfg.num_heads // tp
    assert split["blocks/attn/wk"][-2] == cfg.num_kv_heads // tp
    assert split["blocks/mlp/wi"][-1] == cfg.d_ff // tp
    assert split["embed"][0] == cfg.vocab_size // tp
    assert ranks[0]["cache"]["layers/k"][-2] == cfg.num_kv_heads // tp


@pytest.mark.parametrize("name", list(CASES))
def test_rank_logits_match_one_process_and_jax(groups, name):
    _, ranks, one, jlogits = groups[name]
    assert len(ranks[0]["logits"]) == len(one) == len(jlogits) == 4
    for step, (got, exp, jexp) in enumerate(zip(ranks[0]["logits"], one, jlogits)):
        torch.testing.assert_close(got, exp, rtol=2e-4, atol=2e-4, msg=f"step {step}")
        np.testing.assert_allclose(got.numpy(), jexp, rtol=2e-3, atol=2e-3,
                                   err_msg=f"step {step}")
        for r in ranks[1:]:
            assert torch.equal(r["logits"][step], got)


class _FakeMesh:
    """What ``shard_params`` and ``build_params`` read of a device mesh: the
    "model" coordinate and size, at a "data" size of 1."""
    mesh_dim_names = ("data", "model")

    def __init__(self, m, n):
        self.sub = type("Sub", (), {"get_local_rank": lambda _: m, "size": lambda _: n})()
        self.data = type("Sub", (), {"get_local_rank": lambda _: 0, "size": lambda _: 1})()

    def __getitem__(self, name):
        return self.data if name == "data" else self.sub


@pytest.mark.parametrize("arch", ["llama3_70b", "mixtral_8x7b"])
def test_build_params_draws_the_blocks_of_the_whole_init(arch):
    model = build_model(get_reduced_config(arch))
    whole = model.init(torch.Generator().manual_seed(5), torch.float32, "cpu")
    for m in range(2):
        built = mesh.build_params(model, torch.Generator().manual_seed(5), torch.float32,
                                  "cpu", mesh=_FakeMesh(m, 2))
        cut = mesh.shard_params(whole, _FakeMesh(m, 2))
        got, exp = dict(mesh.leaves_with_names(built)), dict(mesh.leaves_with_names(cut))
        assert got.keys() == exp.keys()
        for n in exp:
            assert torch.equal(got[n], exp[n]), n
        assert got["blocks/attn/wq"].shape[-2] == 2


class _WithUnrunLeaf:
    """A model whose tree has one more leaf, ``blocks/ssd/w_x`` (an RG-LRU
    name under the SSD), which the serve rules place on "model" and no
    layer runs."""

    def __init__(self, model):
        self.model = model

    def init(self, generator, dtype=torch.float32, device=None):
        from repro_torch.models.layers import dense_init
        p = self.model.init(generator, dtype, device)
        p["blocks"]["ssd"]["w_x"] = dense_init((64, 64), generator, dtype=dtype, device=device)
        return p


@pytest.mark.parametrize("arch,tp,leaf", [("mamba2_370m", 2, "blocks/ssd/")])
def test_unexecuted_placements_raise_naming_the_leaf(arch, tp, leaf):
    """A placement no layer runs raises in ``shard_params`` and in
    ``build_params``, which checks on the meta tree before it draws a
    leaf."""
    model = _WithUnrunLeaf(build_model(get_reduced_config(arch)))
    whole = model.init(torch.Generator().manual_seed(0), torch.float32, "meta")
    with pytest.raises(ValueError, match=leaf):
        mesh.shard_params(whole, _FakeMesh(0, tp))
    with pytest.raises(ValueError, match=leaf):
        mesh.build_params(model, torch.Generator().manual_seed(0), torch.float32, "meta",
                          mesh=_FakeMesh(0, tp))


# arch, "model" ranks, whether the experts are on their FFN width
EXPERT_PARALLEL = [("qwen3_30b_a3b", 8, False),     # 32 query heads over 4 KV heads
                   ("mixtral_8x7b", 16, True),      # 8 KV heads, 8 experts
                   ("dbrx_132b", 16, False),        # 48 over 8, 16 experts
                   ("dbrx_132b", 8, False)]


@pytest.mark.parametrize("arch,tp,on_ffn_width", EXPERT_PARALLEL)
def test_expert_parallel_placements_at_full_size(arch, tp, on_ffn_width):
    """An MoE tree's attention is split as the serve rules place it, the
    K/V on head_dim where they do not split on heads (and so is its cache,
    ``init_cache(params=)``), and its experts on the expert axis, or on
    their FFN width (``w_in``'s columns, ``w_out``'s rows) where they do not
    divide; nothing raises.  The full configs on the meta device."""
    cfg = get_config(arch).replace(num_layers=1, layer_pattern=None)
    model = build_model(cfg)
    whole = model.init(torch.Generator().manual_seed(0), torch.bfloat16, "meta")
    dims = mesh.model_placements(whole, tp)
    for w in ("wq", "wk", "wv", "wo"):
        assert dims[f"blocks/attn/{w}"] is not None, w
    assert (dims["blocks/moe/w_in"], dims["blocks/moe/w_out"]) == ((-1, -2) if on_ffn_width
                                                                   else (-3, -3))
    assert dims["embed"] == -2
    rank = mesh.shard_params(whole, _FakeMesh(0, tp))
    cache = model.init_cache(1, 16, torch.bfloat16, "meta", params=rank)
    heads = ((cfg.num_kv_heads // tp, cfg.head_dim) if cfg.num_kv_heads % tp == 0
             else (cfg.num_kv_heads, cfg.head_dim // tp))
    assert cache["layers"]["k"].shape[-2:] == rank["blocks"]["attn"]["wk"].shape[-2:] == heads


def test_whole_weights_under_a_mesh_keep_a_whole_cache():
    """The cache's KV heads come from the weights it is given, not from the
    mesh: whole weights, whole heads; a rank's blocks, its heads."""
    model = build_model(get_reduced_config("llama3_70b"))
    whole = model.init(torch.Generator().manual_seed(0), torch.float32, "meta")
    with mesh.use_mesh(_FakeMesh(0, 2)):
        assert model.init_cache(1, 16, torch.float32, "meta")["layers"]["k"].shape[-2] == 2
        assert model.init_cache(1, 16, torch.float32, "meta",
                                params=whole)["layers"]["k"].shape[-2] == 2
        rank = mesh.shard_params(whole)
        assert model.init_cache(1, 16, torch.float32, "meta",
                                params=rank)["layers"]["k"].shape[-2] == 1


def test_launcher_on_four_cpu_ranks():
    """``launch.parallel`` as its CPU rehearsal runs it: the 8-over-4-head
    config on 4 ranks, a prefill and 3 decodes, against the one-process
    model (``check``: each rank's blocks, the ranks' logits, 2e-4)."""
    from repro_torch.launch import parallel
    args = parallel.parse_args(["--arch", "llama3_70b", "--reduced", "--config", "num_heads=8",
                                "--config", "num_kv_heads=4", "--device", "cpu", "--dtype",
                                "float32", "--ranks", "4", "--batch", "2", "--prompt", "16",
                                "--decodes", "3"])
    ranks, ref = parallel.launch(args), parallel.reference(args)
    assert parallel.capacity_factors(args) == [None]
    assert not any(parallel.check(args, ranks, ref, 2e-4).values())   # no kernel on the CPU
    assert [r["params"]["blocks/mlp/wi"][-1] for r in ranks] == [32] * 4
    assert len(parallel.summary(ranks, ref)) == 2
