"""Training on a ("pod", "data", "model") mesh, and the encoder-decoder's
training on a mesh, in gloo groups of CPU ranks, against the one-process
port and the JAX package's ``make_train_step``.

The reference lowers its ``train_4k`` cell on the (2, 16, 16) mesh too,
whose train rules put FSDP over both batch axes ("pod", "data"), pod-major;
and it lowers whisper_base's ``train_4k`` cell, frames and all.  Each group
is 2 or 4 processes of ``tests/_torch_train_worker.py`` (every case of one
world size in one launch), as ``tests/test_torch_train_mesh.py`` runs them:
the port's weights from seed 41 copied into the JAX model's tree, the
numpy batches of seed 41 (whisper's frames standard normal from a
generator of seed 41 of their own), 2 steps of 2 microbatches, AdamW at
eps 1e-2 (``POD_OPT``).

* Reduced ``llama3_8b`` (dense GQA) and ``mamba2_370m`` (the SSD) at
  (2, 2, 1) and (2, 1, 2); ``llama3_8b`` at a ``d_model`` of 66 on
  (2, 2, 1), which the "data" size divides and the batch axes' 4 do not,
  so that every leaf stays whole over them, as the reference's rule takes
  the axes' product.
* Reduced ``whisper_base`` with 32 frames a row at (2, 1) and (2, 2): the
  encoder's, the decoder's and the cross attention's leaves cut by the
  rules, the vocabulary-parallel embedding and logits, the frames' rows
  split with the tokens'.

Each step's loss and grad_norm lie within 2e-4 of the one-process port's
and 2e-3 of the JAX package's (jitted; all but the ``d_model`` 66 case),
equal on every rank; step 1's
gradients and the parameters after the steps, put together from the
blocks (``mesh.whole_leaves(..., pod=)``), within 2e-4 of each
one-process leaf's largest entry; every block has the ``shard_shape`` of
its "train" spec at the mesh.  Without ranks: ``model_placements(...,
"train", data, pod)`` of all 13 full configs at (2, 16, 16) against the
reference's ``_param_spec``; ``launch.train --mesh P,D,M --frames`` on
CPU ranks (whisper_base on (2, 1, 2), one launch for two tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import mesh as jmesh
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.launch import mesh
from repro_torch.models.optim import OptimizerConfig
from repro_torch.models.transformer import build_model
from test_torch_train_mesh import (ALL_IDS, MICROBATCHES, OPT, SEQ, _axis_dim, _jax_train,
                                   _one_process, _setup, _StandInMesh, _start, _to_jax,
                                   _torch_batches, _wait)

torch.set_num_threads(2)    # the suite runs in several workers at once

FRAMES = 32
# eps 1e-2: AdamW moves a coordinate of gradient g by lr·g / (|g| + eps), so
# a rounding δg of g moves the parameter by up to lr·δg·eps / (|g| + eps)²,
# lr·δg / eps where |g| is small.  Whisper's LayerNorm biases start at zero,
# so after 2 steps their largest entry is about 2·lr, and the parameters are
# held only as well as the gradients' rounding over eps allows: its (2, 1)
# and (2, 2) ranks hold every step-1 gradient within 1.03e-6 of each leaf's
# largest entry, and after 2 steps cross/norm/bias lies 3.49e-7 (4.3e-4 of
# its largest entry) from one process's at eps 1e-3, enc_final_norm/bias
# 2.08e-4 of its largest at the 1e-4 of tests/test_torch_train_mesh.py
POD_OPT = dict(OPT, eps=1e-2)
# name: (arch, config overrides, mesh sizes, batch, held against JAX too)
CASES = {
    "llama3_8b_2x2x1": ("llama3_8b", {}, (2, 2, 1), 8, True),
    "llama3_8b_2x1x2": ("llama3_8b", {}, (2, 1, 2), 8, True),
    "mamba2_370m_2x2x1": ("mamba2_370m", {}, (2, 2, 1), 8, True),
    "mamba2_370m_2x1x2": ("mamba2_370m", {}, (2, 1, 2), 8, True),
    # d_model 66: "data" (2) divides it, ("pod", "data") (4) does not; the
    # placement is what it checks, against one process
    "llama3_8b_2x2x1_d66": ("llama3_8b", {"d_model": 66}, (2, 2, 1), 8, False),
    "whisper_base_2x1": ("whisper_base", {}, (2, 1), 8, True),
    "whisper_base_2x2": ("whisper_base", {}, (2, 2), 8, True),
}


def _names(sizes):
    return ("pod", "data", "model")[-len(sizes):]


def _with_frames(arch, cfg, batches):
    """The numpy batches with an encoder-decoder's frames: (tokens, labels)
    or (tokens, labels, frames)."""
    if cfg.encoder is None:
        return batches
    rng = np.random.default_rng(41)
    return [(t, lab, rng.standard_normal((t.shape[0], FRAMES, cfg.d_model)).astype(np.float32))
            for t, lab in batches]


def _jax_steps(arch, overrides, params, batches):
    """Each step's (loss, grad_norm) of the JAX package's train step, jitted,
    with the frames where the batches carry them."""
    if len(batches[0]) == 2:
        return _jax_train(*_to_jax(arch, overrides, params), batches, POD_OPT)
    from repro.models.optim import OptimizerConfig as JaxOptimizerConfig
    from repro.models.optim import init_adamw as jax_init_adamw
    from repro.models.optim import make_train_step as jax_make_train_step
    jcfg, jp = _to_jax(arch, overrides, params)
    step = jax.jit(jax_make_train_step(jax_build_model(jcfg), JaxOptimizerConfig(**POD_OPT),
                                       microbatches=MICROBATCHES, remat=True))
    opt, out = jax_init_adamw(jp), []
    for tokens, labels, frames in batches:
        jp, opt, m = step(jp, opt, {"tokens": jnp.asarray(tokens, jnp.int32),
                                    "labels": jnp.asarray(labels, jnp.int32),
                                    "frontend_embeds": jnp.asarray(frames)})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _batches(batches):
    if len(batches[0]) == 2:
        return _torch_batches(batches)
    return [{"tokens": torch.from_numpy(t), "labels": torch.from_numpy(lab),
             "frontend_embeds": torch.from_numpy(fe)} for t, lab, fe in batches]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{case name: (config, whole params, the ranks' results, one-process
    results, JAX's (loss, grad_norm) a step)}: the ranks of each world size
    start first and run while JAX and the one-process port train."""
    tmp = tmp_path_factory.mktemp("train_pod")
    built = {}
    for name, (arch, overrides, _, batch, _) in CASES.items():
        cfg, params, batches = _setup(arch, overrides, batch)
        built[name] = cfg, params, _with_frames(arch, cfg, batches)
    started = {}
    for world in sorted({int(np.prod(c[2])) for c in CASES.values()}):
        cases = {name: {"cfg": built[name][0], "params": built[name][1], "mesh": c[2],
                        "batches": _batches(built[name][2]), "microbatches": MICROBATCHES,
                        "opt": OptimizerConfig(**POD_OPT)}
                 for name, c in CASES.items() if int(np.prod(c[2])) == world}
        started[world] = _start(world, tmp, cases)
    jax_runs, one = {}, {}
    for name, (arch, overrides, _, _, with_jax) in CASES.items():
        cfg, params, batches = built[name]
        key = (arch, tuple(sorted(overrides.items())))
        if key not in one:
            jax_runs[key] = _jax_steps(arch, overrides, params, batches) if with_jax else None
            one[key] = _one_process(cfg, params, _batches(batches), POD_OPT)
    ranks = {world: _wait(world, *started[world]) for world in started}
    return {name: (built[name][0], built[name][1], [r[name] for r in ranks[int(np.prod(c[2]))]],
                   one[(c[0], tuple(sorted(c[1].items())))],
                   jax_runs[(c[0], tuple(sorted(c[1].items())))])
            for name, c in CASES.items()}


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
    sizes = CASES[name][2]
    pod = sizes[0] if len(sizes) == 3 else 1
    data, tp = sizes[-2:]
    assert [r["coords"] for r in ranks] == [(i, j) for i in range(pod * data) for j in range(tp)]
    whole = {key: mesh.whole_leaves(params, data, tp, [r[key] for r in ranks], pod)
             for key in ("grads", "final")}
    for key, exp in (("grads", grads), ("final", final)):
        assert whole[key].keys() == exp.keys()
        for leaf, e in exp.items():
            err = float((whole[key][leaf] - e).detach().abs().max())
            assert err <= 2e-4 * float(e.detach().abs().max()), (key, leaf, err)


@pytest.mark.parametrize("name", list(CASES))
def test_blocks_are_the_train_placements(groups, name):
    """Every block has the ``shard_shape`` of its "train" spec at the mesh,
    FSDP over the batch axes' product; the leaves cut over them were
    gathered and every gradient reduced, none gathered where the product
    divides no FSDP dimension (``d_model`` 66 over 4)."""
    cfg, params, ranks, _, _ = groups[name]
    sizes = CASES[name][2]
    axes = mesh.MeshAxes(_names(sizes), sizes)
    spec_of = mesh.named_specs(mesh.param_specs(params, axes, "train"))
    expect = {n: mesh.shard_shape(tuple(leaf.shape), spec_of[n], axes)
              for n, leaf in mesh.leaves_with_names(params)}
    batch_ranks = axes.batch_size()
    for r in ranks:
        assert r["shapes"] == expect
        assert r["reduced"] > 0
        assert (r["gathered"] > 0) == (cfg.d_model % batch_ranks == 0)
    if cfg.d_model % batch_ranks == 0:
        assert expect["embed"][-1] == cfg.d_model // batch_ranks
    else:
        assert cfg.d_model % sizes[-2] == 0
        assert all(spec_of[n] == tuple(None if e in (("pod", "data"), "data") else e
                                       for e in spec_of[n]) for n in spec_of)


@pytest.mark.parametrize("arch", ALL_IDS)
def test_pod_train_placements_are_the_reference_rules(arch):
    """Each leaf's ("model", batch axes) dimensions in "train" mode at the
    (2, 16, 16) mesh (``model_placements(..., "train", 16, pod=2)``) are
    those of the reference's ``_param_spec`` on its full-size tree, FSDP
    over ("pod", "data") where their product, 32, divides the dimension."""
    shape = (2, 16, 16)
    ax = jmesh.MeshAxes(_StandInMesh(("pod", "data", "model"), shape))
    model = build_model(get_config(arch))
    whole = model.init(torch.Generator().manual_seed(0), torch.bfloat16, "meta")
    dims = mesh.model_placements(whole, shape[2], "train", shape[1], shape[0])
    jtree = jax_build_model(jax_get_config(arch)).abstract_params(jnp.bfloat16)
    jleaves = {jmesh._leaf_name(path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert dims.keys() == jleaves.keys()
    for name, jshape in jleaves.items():
        spec = jmesh._param_spec(name, tuple(jshape), ax, "train")
        assert dims[name] == (_axis_dim(spec, len(jshape), "model"),
                              _axis_dim(spec, len(jshape), "data")), name


@pytest.fixture(scope="module")
def launched():
    """``launch.train`` with ``--mesh 2,1,2`` and ``--frames 32``, as phases
    38 and 39 run a pod mesh and an encoder-decoder on the card, at reduced
    size in one launch: whisper_base, 2 steps; (args, the ranks' results,
    the one-process run, step 1's gradients' distances)."""
    from repro_torch.launch import train
    args = train.parse_args(["--arch", "whisper_base", "--mesh", "2,1,2", "--frames", "32",
                             "--device", "cpu", "--steps", "2", "--batch", "8", "--seq",
                             str(SEQ), "--log-every", "1"])
    ranks, ref = train.launch(args), train.reference(args)
    return args, ranks, ref, train.gradient_errors(args, ranks, ref)


def test_launcher_trains_on_a_pod_mesh(launched):
    """The launcher's ranks on (2, 1, 2) against its one-process run
    (``train.check``: blocks at the pod mesh, losses and norms, step 1's
    gradients put together pod-major), FSDP gathers over ("pod", "data")."""
    from repro_torch.launch import train
    args, ranks, ref, errs = launched
    assert train.mesh_axes(args).names == ("pod", "data", "model")
    assert not any(train.check(args, ranks, ref, errs, loss_tol=2e-4, norm_tol=2e-4,
                               leaf_tol=2e-4).values())       # no kernel on the CPU
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert ranks[0]["history"][0]["gathered"] > 0


def test_launcher_feeds_an_encoder_decoder_frames(launched):
    """``--frames`` gives every batch its frames from the seed (the same on
    every rank and in one process: the losses agree), an encoder-decoder
    without them, or frames for a decoder, is refused."""
    from repro_torch.launch import train
    args, ranks, ref, _ = launched
    batch = next(train.data_stream(512, 8, SEQ, 1234, 0, "cpu", frames=32, d_model=64))
    assert batch["frontend_embeds"].shape == (8, 32, 64)
    assert [h["loss"] for h in ranks[0]["history"]] == pytest.approx(
        [h["loss"] for h in ref["history"]], rel=2e-4)
    assert train.kernel_launches(args)["flash_attention"] == (2 * 2 * 2 + 2) * 2
    with pytest.raises(ValueError, match="frames"):
        train.model_config(train.parse_args(["--arch", "whisper_base"]))
    with pytest.raises(ValueError, match="frames"):
        train.model_config(train.parse_args(["--arch", "llama3_8b", "--frames", "8"]))
