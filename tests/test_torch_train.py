"""The port's training path against the JAX package's, on the CPU in fp32,
for the 13 reduced configs (``tests/test_models_smoke.py``'s ``ALL_IDS``).

Both packages get the same parameters (the JAX init, carried over by
``repro_torch.models.convert.from_numpy``) and the same batches, made with
numpy from a seed.  Held to:

* ``train_loss`` (with and without remat): the loss within 1e-5
  (relative) of the JAX loss, the same metric keys;
* every gradient leaf within rtol 1e-4, atol 1e-6 of ``jax.grad``'s;
* ``adamw_update`` over several steps of ``cosine_lr``, both packages fed
  the same numpy gradients (the first AdamW step is about sign(g), so a
  near-zero gradient that the two frameworks compute a hair apart would
  flip an update; shared gradients hold the optimizer alone): parameters,
  moments, step, ``grad_norm`` and ``lr`` within 1e-6 (relative), with
  ``grad_allreduce_dtype`` None and ``"bfloat16"``; the port's norm within
  1e-6 of the exact (fp64) one, and where the reference's fp32 norm is
  further off the exact one (bf16-rounded gradients), the comparison allows
  that measured deviation on top;

and the reference's own checks of ``tests/test_models_smoke.py:32-89``
on the port: a finite loss near ln(vocab), a train step that moves the
parameters, and microbatched steps equal to the monolithic one (1e-4; 1e-2
for MoE, the reference's reason: the load-balance loss is quadratic in the
batch's routing fractions).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, PAPER_ARCH_IDS
from repro.configs import get_reduced_config as jax_reduced_config
from repro.models import optim as jax_optim
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_reduced_config
from repro_torch.models import optim
from repro_torch.models.convert import from_numpy
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)    # the suite runs in several workers at once

ALL_IDS = ARCH_IDS + PAPER_ARCH_IDS
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_RTOL = 1e-6


def _paths(tree, prefix=""):
    """(path, leaf) of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _batch(cfg, seed, B=2, S=32):
    """JAX and port batches: tokens and labels, and frame or frontend
    embeddings (B, F, d) where the config takes them (Whisper: 24 frames)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    jb = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if cfg.frontend is not None or cfg.is_enc_dec:
        frames = cfg.frontend_tokens if cfg.frontend is not None else 24
        fe = (0.02 * rng.standard_normal((B, frames, cfg.d_model))).astype(np.float32)
        jb["frontend_embeds"] = jnp.asarray(fe)
        tb["frontend_embeds"] = torch.from_numpy(fe)
    return jb, tb


@functools.lru_cache(maxsize=None)
def _jax(arch, seed=0):
    """The JAX model, its params (key ``seed``), a batch and the JAX loss,
    metrics and gradients of ``train_loss`` on it (numpy), once per arch.

    ``jax.value_and_grad`` runs op by op, not jitted: XLA's fusions move
    some gradient entries by the fp32 noise of the sum itself (reduced
    recurrentgemma_2b's embedding gradient: the jitted JAX, the eager JAX
    and the port each lie 1.7-2.3e-6 from the fp64 gradient), which is
    above the 1e-6 absolute tolerance held here."""
    cfg = jax_reduced_config(arch)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(seed), jnp.float32)
    jb, _ = _batch(cfg, seed)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p, b: jm.train_loss(p, b, remat=False), has_aux=True)(jp, jb)
    return (cfg, jm, jp, float(loss), {k: float(v) for k, v in metrics.items()},
            dict(_paths(jax.tree.map(np.asarray, grads))))


def _port(arch, jp):
    tm = build_model(get_reduced_config(arch))
    return tm, from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ALL_IDS)
def test_train_loss_matches_jax(arch, remat):
    cfg, _, jp, j_loss, j_metrics, _ = _jax(arch)
    tm, tp = _port(arch, jp)
    _, tb = _batch(cfg, 0)
    with torch.no_grad():
        loss, metrics = tm.train_loss(tp, tb, remat=remat)
    assert float(loss) == pytest.approx(j_loss, rel=LOSS_RTOL)
    assert sorted(metrics) == sorted(j_metrics)
    for key, value in metrics.items():
        assert float(value) == pytest.approx(j_metrics[key], rel=LOSS_RTOL)


@pytest.mark.parametrize("arch", ALL_IDS)
def test_gradients_match_jax(arch):
    cfg, _, jp, _, _, j_grads = _jax(arch)
    tm, tp = _port(arch, jp)
    _, tb = _batch(cfg, 0)
    for _, leaf in _paths(tp):
        leaf.requires_grad_(True)
    loss, _ = tm.train_loss(tp, tb, remat=True)
    loss.backward()
    t_grads = dict(_paths(tp))
    assert sorted(t_grads) == sorted(j_grads)
    for name, leaf in t_grads.items():
        np.testing.assert_allclose(leaf.grad.numpy(), j_grads[name], **GRAD_TOL,
                                   err_msg=f"{arch}: gradient of {name}")


@pytest.mark.parametrize("grad_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("arch", ALL_IDS)
def test_adamw_update_matches_jax(arch, grad_dtype):
    """Three updates (warmup over 2 steps, a cosine to step 5) from the same
    params, each fed the same numpy gradients in both packages; the second
    step's gradients are large enough to be clipped.  The stacked leaves
    keep the reference's decay rule (``p.ndim >= 2``)."""
    cfg, _, jp, _, _, _ = _jax(arch)
    _, tp = _port(arch, jp)
    kw = dict(warmup_steps=2, total_steps=5, grad_allreduce_dtype=grad_dtype)
    j_cfg, t_cfg = jax_optim.OptimizerConfig(**kw), optim.OptimizerConfig(**kw)
    j_state, t_state = jax_optim.init_adamw(jp), optim.init_adamw(tp)
    rng = np.random.default_rng(7)
    rtol = OPT_RTOL
    for scale in (1e-3, 1.0, 1e-2):
        grads = jax.tree.map(
            lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32), jp)
        exact = _exact_norm(grads, grad_dtype)
        jp, j_state, j_m = jax_optim.adamw_update(j_cfg, jp, grads, j_state)
        tp, t_state, t_m = optim.adamw_update(t_cfg, tp, from_numpy(grads, device="cpu"),
                                              t_state)
        # the reference's own fp32 norm is off the exact one by up to ~5e-6
        # on bf16-rounded gradients (XLA's CPU sum over a multi-axis leaf),
        # and its clip factor carries that into the update; the port's
        # norm is held at 1e-6 of the exact one
        j_err = abs(float(j_m["grad_norm"]) - exact) / exact
        rtol = max(rtol, OPT_RTOL + j_err)
        assert float(t_m["grad_norm"]) == pytest.approx(exact, rel=OPT_RTOL)
        assert float(t_m["grad_norm"]) == pytest.approx(float(j_m["grad_norm"]),
                                                        rel=OPT_RTOL + j_err)
        assert float(t_m["lr"]) == pytest.approx(float(j_m["lr"]), rel=OPT_RTOL)
    assert int(t_state.step) == int(j_state.step) == 3
    for what, t_tree, j_tree in (("params", tp, jp), ("mu", t_state.mu, j_state.mu),
                                 ("nu", t_state.nu, j_state.nu)):
        j_leaves = dict(_paths(jax.tree.map(np.asarray, j_tree)))
        for name, leaf in _paths(t_tree):
            np.testing.assert_allclose(leaf.numpy(), j_leaves[name], rtol=rtol,
                                       atol=rtol * float(np.abs(j_leaves[name]).max()),
                                       err_msg=f"{arch}: {what}{name}")


def _exact_norm(grads, grad_dtype):
    """The global norm of ``grads`` after the optional round trip, in fp64."""
    leaves = [np.asarray(g.astype(grad_dtype) if grad_dtype else g, np.float64)
              for g in jax.tree.leaves(grads)]
    return float(np.sqrt(sum(np.sum(g * g) for g in leaves)))


def test_global_norm_and_cosine_lr_match_jax():
    """``global_norm`` over leaves of several shapes and ``cosine_lr``
    through warmup, the cosine and past its end, at 1e-6."""
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((3, 5, 7)).astype(np.float32),
            "b": [rng.standard_normal((11,)).astype(np.float32),
                  rng.standard_normal((4, 9)).astype(np.float32)]}
    assert float(optim.global_norm(from_numpy(tree, device="cpu"))) == pytest.approx(
        float(jax_optim.global_norm(tree)), rel=OPT_RTOL)
    for kw in (dict(warmup_steps=10, total_steps=100), dict(warmup_steps=0, total_steps=1)):
        j_cfg, t_cfg = jax_optim.OptimizerConfig(**kw), optim.OptimizerConfig(**kw)
        for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            assert float(optim.cosine_lr(t_cfg, torch.tensor(step, dtype=torch.int32))) == \
                pytest.approx(float(jax_optim.cosine_lr(j_cfg, jnp.int32(step))), rel=OPT_RTOL)


def test_weight_decay_follows_the_stacked_leaves():
    """The reference decays every leaf with ``ndim >= 2``: in a uniform
    stack the (L, d) norm scales and (L, H, D) qkv biases are decayed, in a
    mixed stack's per-layer list the (d,) norm scales are not."""
    def decayed(arch, path):
        tm = build_model(get_reduced_config(arch))
        params = tm.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
        leaf = dict(_paths(params))[path]
        leaf.fill_(1.0)
        zero = optim.tree_map(torch.zeros_like, params)
        cfg = optim.OptimizerConfig(warmup_steps=1, grad_allreduce_dtype=None)
        optim.adamw_update(cfg, params, zero, optim.init_adamw(params))
        return float(leaf.flatten()[0]) < 1.0

    assert decayed("qwen2_5_3b", "/blocks/norm1/scale")
    assert decayed("qwen2_5_3b", "/blocks/attn/bq")
    assert not decayed("recurrentgemma_2b", "/blocks/0/norm1/scale")
    assert not decayed("qwen2_5_3b", "/final_norm/scale")


# --------------------------------------------------------------------------
# the reference's smoke tests of training (tests/test_models_smoke.py:32-89)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_IDS)
def test_forward_and_loss(arch):
    cfg, _, jp, _, _, _ = _jax(arch)
    tm, tp = _port(arch, jp)
    _, tb = _batch(cfg, 1)
    with torch.no_grad():
        loss, _ = tm.train_loss(tp, tb, remat=False)
    assert loss.shape == ()
    assert np.isfinite(float(loss)), f"{arch}: loss is not finite"
    assert float(loss) > 0.0
    # CE of a random init should be near ln(vocab)
    assert float(loss) < 2.0 * np.log(cfg.vocab_size) + 5.0


@pytest.mark.parametrize("arch", ALL_IDS)
def test_train_step(arch):
    cfg, _, jp, _, _, _ = _jax(arch)
    tm, tp = _port(arch, jp)
    before = [t.clone() for _, t in _paths(tp)]
    step = optim.make_train_step(tm, optim.OptimizerConfig(warmup_steps=1), microbatches=1,
                                 remat=False)
    _, tb = _batch(cfg, 1)
    new_params, new_opt, metrics = step(tp, optim.init_adamw(tp), tb)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(new_opt.step) == 1
    # parameters actually moved
    moved = sum(float((a.detach() - b).abs().sum())
                for (_, a), b in zip(_paths(new_params), before))
    assert moved > 0.0, f"{arch}: train step was a no-op"


@pytest.mark.parametrize("arch", ALL_IDS)
def test_microbatched_train_step_matches(arch):
    """Gradient accumulation (in place, in ``.grad``) must be equivalent to
    the monolithic step."""
    cfg, _, jp, _, _, _ = _jax(arch)
    _, tb = _batch(cfg, 2, B=4, S=16)

    def step_of(mb):
        tm, tp = _port(arch, jp)
        step = optim.make_train_step(tm, optim.OptimizerConfig(), microbatches=mb,
                                     remat=False)
        return step(tp, optim.init_adamw(tp), tb)

    p1, _, m1 = step_of(1)
    p2, _, m2 = step_of(2)
    # MoE: the load-balance aux loss is quadratic in per-batch routing
    # fractions, so mean-of-microbatch aux != full-batch aux (~0.3%); the
    # CE term itself is split-invariant.
    rel = 1e-2 if cfg.moe is not None else 1e-4
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=rel)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]), rel=rel)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "recurrentgemma_2b", "whisper_base"])
def test_microbatches_accumulate_in_place(arch):
    """``value_and_grad`` leaves each gradient in its parameter's ``.grad``,
    the same tensor from step to step (no second parameter-sized buffer),
    and two microbatches give the mean of the two halves' gradients: for a
    uniform stack through per-layer views of the stacked ``.grad``, for a
    mixed one and the encoder-decoder too."""
    cfg, _, jp, _, _, _ = _jax(arch)
    tm, tp = _port(arch, jp)
    _, tb = _batch(cfg, 4, B=4, S=16)
    optim.value_and_grad(tm, tp, tb, microbatches=2, remat=False)
    ptrs = [p.grad.data_ptr() for _, p in _paths(tp)]
    _, _, grads = optim.value_and_grad(tm, tp, tb, microbatches=2, remat=True)
    assert [p.grad.data_ptr() for _, p in _paths(tp)] == ptrs
    assert all(g is p.grad for g, p in zip(optim.tree_leaves(grads), optim.tree_leaves(tp)))
    halves = []
    for half in (slice(0, 2), slice(2, 4)):
        ref_p = _port(arch, jp)[1]
        for leaf in optim.tree_leaves(ref_p):
            leaf.requires_grad_(True)
        loss, _ = tm.train_loss(ref_p, {k: v[half] for k, v in tb.items()}, remat=False)
        loss.backward()
        halves.append(dict(_paths(ref_p)))
    for name, p in _paths(tp):
        torch.testing.assert_close(p.grad, (halves[0][name].grad + halves[1][name].grad) / 2,
                                   rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="microbatches"):
        optim.value_and_grad(tm, tp, tb, microbatches=3)
