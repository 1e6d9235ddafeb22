"""Training on a ("data", "model") mesh of CPU ranks, the reference's
``train_4k`` program (FSDP over "data", Megatron over "model"), against the
one-process port and the JAX package's ``make_train_step``.

Each group is 2, 4 or 8 processes of ``tests/_torch_train_worker.py`` that
meet through a ``FileStore`` under the test's temporary directory; every
child gets ``PYTHONDONTWRITEBYTECODE=1`` and caps torch at 2 threads (1 in
a group of 8).  The weights are the port's from seed 41, copied into the
JAX model's tree (the bridge's names and layouts the other way) and cut
into each rank's blocks by the "train" rules
(``launch.mesh.shard_params(..., mode="train")``); the batches are numpy's
(seed 41), 2 steps of 2 microbatches.

* Reduced ``llama3_8b`` (dense GQA), ``mamba2_370m`` (the SSD's packed
  columns) and ``qwen3_30b_a3b`` (the ragged MoE: experts over "model", d
  over "data") at meshes (2, 2), (2, 1) and (1, 2); a batch whose
  microbatches' 3 rows the 2 "data" ranks do not divide (every rank runs
  all of them); a ``d_model`` of 63, which no FSDP dimension divides (every
  leaf whole over "data").  Each step's loss and grad_norm lie within 2e-4
  of the one-process port's and 2e-3 of the JAX package's ``make_train_step``
  (jitted, one process), equal on every rank; step 1's gradients and the
  parameters after the steps, put together from the blocks
  (``mesh.whole_leaves``), within 2e-4 of each one-process leaf's largest
  entry (AdamW at eps 1e-4: see ``OPT``); every block has the
  ``shard_shape`` of its "train" spec.
* The "model" split's backward pass (ROADMAP C2): the SSD's gated norm,
  the RG-LRU's gathered input and the attention on head_dim (k and v, then
  q and o) at "model" sizes 2 and 4, the SSD at 4 (B and C fetched by
  every rank) and the MoE's experts on their FFN width at 8 (4 experts),
  against the one-process port (loss,
  grad_norm, step 1's gradients and the parameters after the steps; their
  serving is held against JAX elsewhere).
* Without ranks: ``model_placements(..., mode="train")`` of all 13 full
  configs at (16, 16) and (2, 2) against the reference's ``_param_spec``; a
  placement no layer runs raises, naming the leaf; ``build_params`` in
  "train" mode draws the blocks ``shard_params`` cuts; ``moe_impl="a2a"``
  with "data" > 1 raises; the launcher (``launch.train --mesh``) on 4 CPU
  ranks; the float64 witness (``train.witness``) keeps fp64 throughout.
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

from repro.configs import ARCH_IDS, PAPER_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced_config as jax_reduced_config
from repro.launch import mesh as jmesh
from repro.models.optim import OptimizerConfig as JaxOptimizerConfig
from repro.models.optim import init_adamw as jax_init_adamw
from repro.models.optim import make_train_step as jax_make_train_step
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import mesh
from repro_torch.models.optim import (OptimizerConfig, Sharding, adamw_update, init_adamw,
                                      tree_map, value_and_grad)
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)    # the suite runs in several workers at once

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_train_worker.py"
SEQ, STEPS, MICROBATCHES = 16, 2, 2
# eps 1e-4, not 1e-8: AdamW's step m / (sqrt(v) + eps) of a coordinate whose
# gradient is near eps moves by up to lr with the gradient's rounding (at
# eps 1e-8, 2.35e-4 of embed's largest entry after 2 steps on 4 ranks whose
# step-1 gradients are 7e-7 apart); at 1e-4 the step is a well-conditioned
# function of the gradient, and the parameters after the steps can be held
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)
# name: (arch, config overrides, (data, model), batch, held against JAX too)
CASES = {
    "llama3_8b_2x2": ("llama3_8b", {}, (2, 2), 8, True),
    "mamba2_370m_2x2": ("mamba2_370m", {}, (2, 2), 8, True),
    "qwen3_30b_a3b_2x2": ("qwen3_30b_a3b", {}, (2, 2), 8, True),
    "llama3_8b_2x1": ("llama3_8b", {}, (2, 1), 8, True),
    "mamba2_370m_1x2": ("mamba2_370m", {}, (1, 2), 8, True),
    "qwen3_30b_a3b_2x1": ("qwen3_30b_a3b", {}, (2, 1), 8, True),
    "qwen3_30b_a3b_1x2": ("qwen3_30b_a3b", {}, (1, 2), 8, True),
    # 3 rows a microbatch: the 2 "data" ranks each run all of them
    "llama3_8b_2x2_rows_whole": ("llama3_8b", {}, (2, 2), 6, True),
    # no FSDP dimension (d_model) divides over 2: every leaf whole over "data"
    "llama3_8b_2x2_d63": ("llama3_8b", {"d_model": 63}, (2, 2), 8, True),
    # the "model" split's backward pass: k and v on head_dim (2 KV heads, 4
    # ranks), q and o on head_dim too (6 query heads), the RG-LRU's width
    "qwen2_5_3b_1x4": ("qwen2_5_3b", {}, (1, 4), 8, False),
    "llama3_8b_1x4_q_on_head_dim": ("llama3_8b", {"num_heads": 6}, (1, 4), 8, False),
    "recurrentgemma_2b_2x2": ("recurrentgemma_2b", {}, (2, 2), 8, False),
    # 4 experts over 8 "model" ranks: the experts on their FFN width; the
    # SSD's B and C fetched by 4 ranks
    "mixtral_8x7b_1x8_experts_on_ffn": ("mixtral_8x7b", {}, (1, 8), 8, False),
    "mamba2_370m_1x4": ("mamba2_370m", {}, (1, 4), 8, False),
}


def _setup(arch, overrides, batch):
    """(port config, whole port params from seed 41, the batches as numpy
    (tokens, labels))."""
    cfg = get_reduced_config(arch).replace(**overrides)
    rng = np.random.default_rng(41)
    toks = rng.integers(1, cfg.vocab_size, (STEPS, batch, SEQ + 1))
    params = build_model(cfg).init(torch.Generator().manual_seed(41), torch.float32, "cpu")
    return cfg, params, [(t[:, :-1], t[:, 1:]) for t in toks]


def _to_jax(arch, overrides, params):
    """(JAX config, the port's whole tree as the JAX model's params): the
    bridge's names and layouts the other way."""
    jcfg = jax_reduced_config(arch).replace(**overrides)
    named = dict(mesh.leaves_with_names(params))
    tree = jax_build_model(jcfg).abstract_params(jnp.float32)
    return jcfg, jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(named[jmesh._leaf_name(path)].numpy()), tree)


def _jax_train(jcfg, jp, batches, opt=OPT):
    """Each step's (loss, grad_norm) of the JAX package's train step, jitted,
    in one process."""
    step = jax.jit(jax_make_train_step(jax_build_model(jcfg), JaxOptimizerConfig(**opt),
                                       microbatches=MICROBATCHES, remat=True))
    opt, out = jax_init_adamw(jp), []
    for tokens, labels in batches:
        jp, opt, m = step(jp, opt, {"tokens": jnp.asarray(tokens, jnp.int32),
                                    "labels": jnp.asarray(labels, jnp.int32)})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _torch_batches(batches):
    return [{"tokens": torch.from_numpy(t), "labels": torch.from_numpy(lab)}
            for t, lab in batches]


def _one_process(cfg, params, batches, opt=OPT):
    """The port in one process: ([(loss, grad_norm)] a step, step 1's
    gradients, the parameters after the steps), named."""
    model = build_model(cfg)
    params = tree_map(lambda p: p.detach().clone(), params)
    state, out, step1 = init_adamw(params), [], None
    for batch in batches:
        loss, _, grads = value_and_grad(model, params, batch, microbatches=MICROBATCHES)
        if step1 is None:
            step1 = dict(mesh.leaves_with_names(tree_map(lambda g: g.detach().clone(), grads)))
        _, _, m = adamw_update(OptimizerConfig(**opt), params, grads, state)
        out.append((float(loss), float(m["grad_norm"])))
    return out, step1, dict(mesh.leaves_with_names(params))


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
    """{case name: (config, whole params, the ranks' results, one-process
    results, JAX's (loss, grad_norm) a step or None)}: the ranks of each
    world size start first and run while JAX and the one-process port
    train."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    key_of = {name: (arch, tuple(sorted(overrides.items())), batch)
              for name, (arch, overrides, _, batch, _) in CASES.items()}
    built = {key: _setup(key[0], dict(key[1]), key[2]) for key in set(key_of.values())}
    started = {}
    for world in sorted({d * m for _, _, (d, m), _, _ in CASES.values()}):
        cases = {name: {"cfg": built[key_of[name]][0], "params": built[key_of[name]][1],
                        "mesh": shape, "batches": _torch_batches(built[key_of[name]][2]),
                        "microbatches": MICROBATCHES, "opt": OptimizerConfig(**OPT)}
                 for name, (_, _, shape, _, _) in CASES.items() if shape[0] * shape[1] == world}
        started[world] = _start(world, tmp, cases)
    with_jax = {key_of[name] for name, case in CASES.items() if case[4]}
    jax_runs = {key: _jax_train(*_to_jax(key[0], dict(key[1]), built[key][1]), built[key][2])
                for key in with_jax}
    one = {key: _one_process(cfg, params, _torch_batches(batches))
           for key, (cfg, params, batches) in built.items()}
    ranks = {world: _wait(world, *started[world]) for world in started}
    return {name: (built[key_of[name]][0], built[key_of[name]][1],
                   [r[name] for r in ranks[d * m]], one[key_of[name]],
                   jax_runs[key_of[name]] if CASES[name][4] else None)
            for name, (_, _, (d, m), _, _) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_losses_and_norms_match_one_process_and_jax(groups, name):
    _, _, ranks, (one, _, _), jax_steps = groups[name]
    for t, (loss, norm) in enumerate(one):
        got = (ranks[0]["losses"][t], ranks[0]["norms"][t])
        np.testing.assert_allclose(got, (loss, norm), rtol=2e-4, err_msg=f"step {t + 1}")
        if jax_steps is not None:
            np.testing.assert_allclose(got, jax_steps[t], rtol=2e-3, err_msg=f"step {t + 1}")
        for r in ranks[1:]:
            assert (r["losses"][t], r["norms"][t]) == got


@pytest.mark.parametrize("name", list(CASES))
def test_step1_gradients_and_parameters_match_one_process(groups, name):
    _, params, ranks, (_, grads, final), _ = groups[name]
    d, m = CASES[name][2]
    assert [r["coords"] for r in ranks] == [(i, j) for i in range(d) for j in range(m)]
    whole = {"grads": mesh.whole_leaves(params, d, m, [r["grads"] for r in ranks]),
             "final": mesh.whole_leaves(params, d, m, [r["final"] for r in ranks])}
    for key, exp in (("grads", grads), ("final", final)):
        assert whole[key].keys() == exp.keys()
        for leaf, e in exp.items():
            err = float((whole[key][leaf] - e).detach().abs().max())
            assert err <= 2e-4 * float(e.detach().abs().max()), (key, leaf, err)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[2][0] > 1])
def test_blocks_are_the_train_placements(groups, name):
    """Every block has the ``shard_shape`` of its "train" spec; the leaves
    cut over "data" were gathered and their gradients reduced (bytes over
    "data"), none where no FSDP dimension divides."""
    cfg, params, ranks, _, _ = groups[name]
    axes = mesh.MeshAxes(("data", "model"), CASES[name][2])
    spec_of = mesh.named_specs(mesh.param_specs(params, axes, "train"))
    expect = {n: mesh.shard_shape(tuple(leaf.shape), spec_of[n], axes)
              for n, leaf in mesh.leaves_with_names(params)}
    for r in ranks:
        assert r["shapes"] == expect
        assert r["reduced"] > 0
        assert (r["gathered"] > 0) == (cfg.d_model % 2 == 0)
    assert expect["final_norm/scale"] == tuple(params["final_norm"]["scale"].shape)
    if cfg.d_model % 2 == 0:
        assert expect["embed"][-1] == cfg.d_model // 2


@pytest.mark.parametrize("name", list(CASES))
def test_rank_census_equals_what_each_rank_issued(groups, name):
    """``launch.rank_cost``'s census of each rank's step on the meta device
    (``train_program`` in a stand-in group of the case's mesh) equals what
    the rank recorded at each of its steps: the collectives' result bytes
    and ops by kind exactly, and the product FLOPs exactly where no grouped
    product runs on the rank's block of the experts (there the meta run
    counts every row it is given, a real rank the routed ones alone)."""
    from repro_torch.launch import rank_cost
    cfg, _, ranks, _, _ = groups[name]
    B = CASES[name][3]
    batch = {k: torch.empty((B, SEQ), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    axes = mesh.MeshAxes(("data", "model"), CASES[name][2])
    for r in ranks:
        coords = dict(zip(("data", "model"), r["coords"]))
        meta = rank_cost.census(axes, coords, lambda: rank_cost.train_program(
            cfg, batch, MICROBATCHES, dtype=torch.float32))
        assert len(r["census"]) == STEPS
        for real in r["census"]:
            assert meta["bytes_by_op"] == real["bytes_by_op"], coords
            assert meta["ops_by_op"] == real["ops_by_op"], coords
            if cfg.moe is None:
                assert meta["flops"] == real["flops"], coords
            else:
                assert real["flops"] <= meta["flops"], coords
        assert sum(meta["ops_by_op"].values()) > 0     # the norm's all-reduce at least


# --------------------------------------------------------------------------
# without ranks
# --------------------------------------------------------------------------

ALL_IDS = list(ARCH_IDS) + list(PAPER_ARCH_IDS)


class _StandInMesh:
    """What the reference's ``MeshAxes`` reads of a ``jax.sharding.Mesh``."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.devices = np.zeros(sizes, dtype=np.int8)


def _axis_dim(spec, ndim, axis):
    for i, entry in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return i - ndim
    return None


@pytest.mark.parametrize("shape", [(16, 16), (2, 2)])
@pytest.mark.parametrize("arch", ALL_IDS)
def test_train_placements_are_the_reference_rules(arch, shape):
    """Each leaf's ("model", "data") dimensions in "train" mode are those of
    the reference's ``_param_spec`` on its full-size tree; nothing raises."""
    jm = _StandInMesh(("data", "model"), shape)
    ax = jmesh.MeshAxes(jm)
    model = build_model(get_config(arch))
    whole = model.init(torch.Generator().manual_seed(0), torch.bfloat16, "meta")
    dims = mesh.model_placements(whole, shape[1], "train", shape[0])
    jtree = jax_build_model(jax_get_config(arch)).abstract_params(jnp.bfloat16)
    jleaves = {jmesh._leaf_name(path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert dims.keys() == jleaves.keys()
    for name, jshape in jleaves.items():
        spec = jmesh._param_spec(name, tuple(jshape), ax, "train")
        assert dims[name] == (_axis_dim(spec, len(jshape), "model"),
                              _axis_dim(spec, len(jshape), "data")), name


def test_unrun_train_placements_raise_naming_the_leaf():
    """A leaf that the train rules place on "data" where no layer gathers
    it, and one they place on "model" where no layer runs its block."""
    whole = build_model(get_reduced_config("llama3_8b")).init(
        torch.Generator().manual_seed(0), torch.float32, "meta")
    whole["blocks"]["attn"]["router"] = torch.empty((2, 64, 4), device="meta")
    with pytest.raises(ValueError, match="blocks/attn/router.*'data'"):
        mesh.model_placements(whole, 2, "train", 2)
    whole["blocks"]["attn"].pop("router")
    whole["blocks"]["ssd"] = {"w_x": torch.empty((2, 64, 64), device="meta")}
    with pytest.raises(ValueError, match="blocks/ssd/w_x"):
        mesh.model_placements(whole, 2, "train", 2)


class _FakeMesh:
    """What ``shard_params`` and ``build_params`` read of a device mesh: the
    "data" and "model" coordinates and sizes."""
    mesh_dim_names = ("data", "model")

    def __init__(self, d, data, m, model):
        self.subs = {name: type("Sub", (), {"get_local_rank": lambda _, i=i: i,
                                            "size": lambda _, n=n: n})()
                     for name, i, n in (("data", d, data), ("model", m, model))}

    def __getitem__(self, name):
        return self.subs[name]


@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_370m", "qwen3_30b_a3b"])
def test_build_params_in_train_mode_draws_the_blocks_of_the_whole_init(arch):
    model = build_model(get_reduced_config(arch))
    whole = model.init(torch.Generator().manual_seed(5), torch.float32, "cpu")
    blocks = []
    for d in range(2):
        for m in range(2):
            fake = _FakeMesh(d, 2, m, 2)
            built = mesh.build_params(model, torch.Generator().manual_seed(5), torch.float32,
                                      "cpu", mesh=fake, mode="train")
            cut = mesh.shard_params(whole, fake, mode="train")
            got, exp = dict(mesh.leaves_with_names(built)), dict(mesh.leaves_with_names(cut))
            assert got.keys() == exp.keys()
            for n in exp:
                assert torch.equal(got[n], exp[n]), n
            blocks.append(built)
    assert blocks[0]["embed"].shape == (whole["embed"].shape[0] // 2,
                                        whole["embed"].shape[1] // 2)
    back = mesh.whole_leaves(whole, 2, 2, blocks)
    for n, leaf in mesh.leaves_with_names(whole):
        assert torch.equal(back[n], leaf), n


def test_a2a_moe_with_data_ranks_raises():
    """The reference's a2a auxiliary loss over "data" is one shard's
    statistic (ROADMAP F7): training it over 2 "data" ranks raises before
    any collective."""
    cfg = get_reduced_config("qwen3_30b_a3b").replace(moe_impl="a2a")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    dims = tree_map(lambda _: None, params)
    sharding = Sharding(dims=dims, replicas=dims, group=None, rank=0, size=2)
    batch = {"tokens": torch.ones((4, 8), dtype=torch.long),
             "labels": torch.ones((4, 8), dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="F7"):
        value_and_grad(model, params, batch, sharding=sharding)


def test_launcher_on_four_cpu_ranks():
    """``launch.train --mesh 2,2`` as its CPU rehearsal runs it: reduced
    llama3_8b, 2 steps, its ranks against its one-process run
    (``train.check``: blocks, losses and norms, step 1's gradients), rank
    0's log lines the reference's."""
    from repro_torch.launch import train
    args = train.parse_args(["--arch", "llama3_8b", "--device", "cpu", "--mesh", "2,2",
                             "--steps", "2", "--batch", "8", "--seq", "16", "--log-every", "1"])
    ranks, ref = train.launch(args), train.reference(args)
    errs = train.gradient_errors(args, ranks, ref)
    assert not any(train.check(args, ranks, ref, errs, loss_tol=2e-4, norm_tol=2e-4,
                               leaf_tol=2e-4).values())       # no kernel on the CPU
    assert [line.split()[:2] for line in ranks[0]["lines"][:2]] == [["step", "1"], ["step", "2"]]
    assert ranks[0]["history"][0]["gathered"] > 0
    assert len(train.summary(args, ranks, ref, errs)) == 3
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(["--arch", "llama3_8b", "--device", "cpu", "--mesh", "2,1",
                    "--ckpt-dir", "unused"])


def test_float64_witness_keeps_float64_and_sits_by_the_fp32_step():
    """``train.witness``: the SSD model's plain path in fp64 throughout (1
    and 2 microbatches agree to 1e-12 of each leaf's largest entry, where
    one fp32 rounding on the path would leave ~1e-7), within 1e-4 of the
    one process's fp32 step 1; a model with attention raises."""
    from repro_torch.launch import train
    argv = ["--arch", "mamba2_370m", "--device", "cpu", "--steps", "1", "--batch", "4",
            "--seq", "32"]
    args = {mb: train.parse_args(argv + ["--microbatches", str(mb)]) for mb in (1, 2)}
    exact = {mb: train.witness(a) for mb, a in args.items()}
    assert {g.dtype for g in exact[2].values()} == {torch.float64}
    assert max(train.leaf_errors(exact[1], exact[2]).values()) < 1e-12
    fp32 = dict(mesh.leaves_with_names(train.reference(args[2])["grads"]))
    assert max(train.leaf_errors(fp32, exact[2]).values()) < 1e-4
    with pytest.raises(ValueError, match="float64"):
        train.witness(train.parse_args(["--arch", "llama3_8b", "--device", "cpu"]))
