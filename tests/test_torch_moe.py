"""The port's dropless MoE against ``repro.models.layers.moe`` on the CPU.

Reduced ``mixtral_8x7b`` (8 experts cut to 4, top-2), ``qwen3_30b_a3b``
(top-2 of 4 at d_ff 64) and ``dbrx_132b`` (top-2 of 4, LayerNorm model): the
JAX parameters of one layer are carried over with
``repro_torch.models.convert`` (the router stays fp32), the inputs are made
with numpy from a seed, and in fp32 the top-k expert ids must be identical
before ``y``, ``moe_aux_loss`` and ``expert_load`` are compared at 1e-5.
Batches include one in which some expert gets no token.  The grouped call
(``torch._grouped_mm``, what the card runs) is held against the per-expert
loop, its plain version, on the CPU, which runs both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_reduced_config
from repro_torch.models import layers as TL
from repro_torch.models.convert import from_numpy

torch.set_num_threads(2)    # the suite runs in several workers at once

ARCHS = ["mixtral_8x7b", "qwen3_30b_a3b", "dbrx_132b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _layer(arch, seed):
    """The JAX and port parameters of layer 0's MoE."""
    cfg = jax_reduced_config(arch)
    jp = jax_build_model(cfg).init(jax.random.key(seed), jnp.float32)
    jmoe = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    tmoe = from_numpy(jax.tree.map(np.asarray, jmoe), device="cpu")
    return get_reduced_config(arch), jmoe, tmoe


def _check(cfg, jmoe, tmoe, x):
    """Top-k ids identical, then y and the aux outputs at 1e-5."""
    K = cfg.moe.top_k
    xf = x.reshape(-1, cfg.d_model)
    j_probs = jax.nn.softmax(jnp.asarray(xf) @ jmoe["router"], axis=-1)
    j_gate, j_idx = jax.lax.top_k(j_probs, K)
    t_probs, t_gate, t_idx = TL.moe_route(cfg, tmoe, torch.from_numpy(xf))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(
        t_gate.numpy(), np.asarray(j_gate / j_gate.sum(-1, keepdims=True)), **TOL)

    t_y, t_aux = TL.moe(cfg, tmoe, torch.from_numpy(x))
    j_y, j_aux = JL.moe(cfg, jmoe, jnp.asarray(x))
    assert t_y.dtype == torch.float32 and t_y.shape == x.shape
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), **TOL)
    for key in ("moe_aux_loss", "expert_load"):
        np.testing.assert_allclose(t_aux[key].numpy(), np.asarray(j_aux[key]), **TOL)
    return t_aux["expert_load"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 9), (3, 33)])
def test_moe_matches_jax(arch, shape):
    cfg, jmoe, tmoe = _layer(arch, 0)
    x = np.random.default_rng(shape[1]).standard_normal(shape + (cfg.d_model,))
    load = _check(cfg, jmoe, tmoe, x.astype(np.float32))
    assert float(load.sum()) == pytest.approx(1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_with_an_expert_that_gets_no_token(arch):
    """One token picks K of E experts, so E - K get none; and a batch whose
    router never picks expert 0 (its column pushed far down)."""
    cfg, jmoe, tmoe = _layer(arch, 1)
    rng = np.random.default_rng(7)
    x1 = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    load = _check(cfg, jmoe, tmoe, x1)
    assert int((load == 0).sum()) == cfg.moe.num_experts - cfg.moe.top_k

    router = np.asarray(jmoe["router"]).copy()
    router[:, 0] = -np.abs(router).sum(axis=0).max()     # expert 0 scores lowest always
    jmoe = dict(jmoe, router=jnp.asarray(router))
    tmoe = dict(tmoe, router=torch.from_numpy(router))
    x = np.abs(rng.standard_normal((2, 12, cfg.d_model))).astype(np.float32)
    load = _check(cfg, jmoe, tmoe, x)
    assert float(load[0]) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", [[3, 0, 5, 8], [0, 0, 16, 0], [1, 1, 1, 1]])
def test_grouped_call_matches_the_loop(sizes, dtype):
    """``torch._grouped_mm`` with the cumulative sizes, the card's call,
    against the per-expert loop, including empty groups; exact in fp32 on
    the CPU, 2e-2 in bf16."""
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((sum(sizes), 64)).astype(np.float32)).to(dt)
    w = torch.from_numpy(rng.standard_normal((4, 64, 128)).astype(np.float32) / 8).to(dt)
    gs = torch.tensor(sizes, dtype=torch.int32)
    grouped = torch._grouped_mm(x, w, offs=torch.cumsum(gs, 0, dtype=torch.int32))
    loop = TL.grouped_mm_loop(x, w, gs)
    assert grouped.dtype == loop.dtype == dt
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(grouped.float().numpy(), loop.float().numpy(), rtol=tol, atol=tol)
    # the dispatch sends a CPU tensor to the loop
    assert torch.equal(TL.grouped_mm(x, w, gs), loop)


def test_moe_layer_grouped_call_matches_the_loop():
    """The whole MoE layer of reduced qwen3_30b_a3b with its two products as
    one grouped call each, against the loop (as chip_smoke holds them on the
    card)."""
    cfg, _, tmoe = _layer("qwen3_30b_a3b", 2)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 40, cfg.d_model)).astype(np.float32))
    probs, gate, idx = TL.moe_route(cfg, tmoe, x.reshape(-1, cfg.d_model))
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    xs = x.reshape(-1, cfg.d_model)[order // cfg.moe.top_k]
    gs = torch.bincount(flat, minlength=cfg.moe.num_experts).int()
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    h = torch._grouped_mm(xs, tmoe["w_in"], offs=offs)
    np.testing.assert_allclose(h.numpy(), TL.grouped_mm_loop(xs, tmoe["w_in"], gs).numpy(),
                               **TOL)


def test_moe_params_layout_and_types():
    """The reference's layouts: router (d, E) fp32 whatever the model's type,
    w_in (E, d, 2 F_e), w_out (E, F_e, d), a leading layer axis before each;
    the bridge keeps the router fp32 when it casts the rest to bf16."""
    cfg = get_reduced_config("qwen3_30b_a3b")
    E, F_e, d = cfg.moe.num_experts, cfg.moe.d_ff_expert, cfg.d_model
    p = TL.moe_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu", lead=(3,))
    assert p["router"].shape == (3, d, E) and p["router"].dtype == torch.float32
    assert p["w_in"].shape == (3, E, d, 2 * F_e) and p["w_in"].dtype == torch.bfloat16
    assert p["w_out"].shape == (3, E, F_e, d) and p["w_out"].dtype == torch.bfloat16
    # fan-in on axis 1 of each expert's matrix: |w| <= 2 / sqrt(fan_in)
    assert float(p["w_in"].float().abs().max()) <= 2 / d ** 0.5 + 1e-2
    assert float(p["w_out"].float().abs().max()) <= 2 / F_e ** 0.5 + 1e-2
    _, jmoe, _ = _layer("qwen3_30b_a3b", 0)
    conv = from_numpy(jax.tree.map(np.asarray, jmoe), device="cpu", dtype=torch.bfloat16)
    assert conv["router"].dtype == torch.float32
    assert conv["w_in"].dtype == conv["w_out"].dtype == torch.bfloat16


def test_moe_rejects_an_unknown_force():
    cfg, _, tmoe = _layer("mixtral_8x7b", 0)
    with pytest.raises(ValueError, match="force"):
        TL.moe(cfg, tmoe, torch.zeros((1, 2, cfg.d_model)), force="kernel")


@pytest.mark.parametrize("arch", ARCHS)
def test_combine_is_a_fixed_order_sum(arch, monkeypatch):
    """ROADMAP C1: the combine of each token's K weighted expert outputs is a
    sum over a fixed axis, not a floating-point ``index_add_``, whose atomic
    adds on the card land in a varying order and round a bf16 row
    differently from run to run.  The MoE runs with such an ``index_add_``
    refused, and equals the per-token sum of its choices' gated expert
    outputs at 1e-5."""
    real = torch.Tensor.index_add_

    def integer_only(self, *args, **kw):
        assert not self.is_floating_point(), "a floating-point index_add_"
        return real(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "index_add_", integer_only)
    cfg, _, p = _layer(arch, 3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 9, cfg.d_model))
                         .astype(np.float32))
    y, _ = TL.moe(cfg, p, x)
    xf = x.reshape(-1, cfg.d_model)
    _, gate, idx = TL.moe_route(cfg, p, xf)
    outs = []
    for k in range(cfg.moe.top_k):               # each choice's expert, one token at a time
        rows = []
        for t in range(xf.shape[0]):
            e = int(idx[t, k])
            h = xf[t:t + 1] @ p["w_in"][e]
            hi, hg = torch.chunk(h, 2, dim=-1)
            rows.append((torch.nn.functional.silu(hi) * hg) @ p["w_out"][e])
        outs.append(torch.cat(rows))
    expect = (torch.stack(outs, 1) * gate[..., None]).sum(1)
    torch.testing.assert_close(y.reshape(-1, cfg.d_model), expect, **TOL)
