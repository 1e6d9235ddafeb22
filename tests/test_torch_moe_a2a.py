"""The port's expert-parallel MoE (``repro_torch.models.layers.moe_a2a``) in
gloo groups of CPU processes, against the port's dropless MoE and against the
reference's own ``moe_a2a``.

Each group is 2 or 4 processes of ``tests/_torch_moe_a2a_worker.py`` that
meet through a ``FileStore`` under the test's temporary directory; every
child gets ``PYTHONDONTWRITEBYTECODE=1`` and caps torch at 2 threads.

* At meshes (1, 2), (1, 4) and (2, 2), at a capacity that drops nothing,
  ``moe_a2a`` on each rank's data block equals ``moe`` on the same block in
  fp32 at 2e-4 (``tests/test_moe_a2a.py``'s tolerance), and its statistics
  are the dropless ones.
* At capacity_factor 1.0, where pairs drop, at (1, 4) and (2, 2): the
  reference's ``moe_a2a`` in a JAX subprocess with 4 host devices and the
  port's ranks read the same numpy inputs (seed 0).  The port's y equals
  the reference's at 2e-4, and the dropped (token, choice) pairs are the
  same: read from each y as the subset of every token's K weighted expert
  outputs (float64, from the same weights) that sums to it, and counted by
  the port's ``dropped``.
* ``train_loss`` of reduced mixtral through ``moe_a2a`` at no drops, with
  the all-to-all (16 positions) and with its fallback (7, which 2 ranks do
  not split): the loss at 1e-6 and every gradient leaf at rtol 1e-4 against
  the dropless model, the router's summed over "model", the experts' each
  rank's own slice.
* The fallbacks: T % ep (the dropless MoE on the sharded experts), no mesh,
  and a model's prefill (the all-to-all) and decode (the fallback) against
  the dropless model.
* The launcher (``repro_torch.launch.parallel``) on the CPU: reduced
  mixtral on 4 ranks of one expert each, its ranks' prefills and decode
  against its one-process dropless model (``parallel.check`` at 2e-4);
  reduced qwen3_30b_a3b on more ranks than KV heads, its K/V on head_dim
  on each rank.
"""

import os
import subprocess
import sys
from itertools import product
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.launch import mesh
from repro_torch.models import layers as L
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)    # the suite runs in several workers at once

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_moe_a2a_worker.py"
TOL = 2e-4
# the capacity-drop case: tests/test_moe_a2a.py's MoE (8 experts, top-2)
B, T, D_MODEL, E, K, F_E = 4, 16, 64, 8, 2, 128

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.models.config import ModelConfig, MoEConfig
from repro.models import layers as L

z = np.load(sys.argv[1])
E, F = z["w_out"].shape[:2]
cfg = ModelConfig(arch_id="moe_test", family="moe", num_layers=1, d_model=z["x"].shape[-1],
                  num_heads=4, num_kv_heads=4, d_ff=F, vocab_size=256, head_dim=16,
                  moe=MoEConfig(num_experts=E, top_k=int(z["top_k"]), d_ff_expert=F,
                                capacity_factor=1.0))
p = {k: jnp.asarray(z[k]) for k in ("router", "w_in", "w_out")}
out = {}
for shape in ((1, 4), (2, 2)):
    with jax.make_mesh(shape, ("data", "model")):
        y, _ = jax.jit(lambda p, x: L.moe_a2a(cfg, p, x))(p, jnp.asarray(z["x"]))
    out[str(shape)] = np.asarray(y)
np.savez(sys.argv[2], **out)
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), PYTHONDONTWRITEBYTECODE="1",
               JAX_PLATFORMS="cpu", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def _inputs(path):
    rng = np.random.default_rng(0)
    np.savez(path, x=rng.standard_normal((B, T, D_MODEL)).astype(np.float32),
             router=(rng.standard_normal((D_MODEL, E)) / np.sqrt(D_MODEL)).astype(np.float32),
             w_in=(rng.standard_normal((E, D_MODEL, 2 * F_E)) / np.sqrt(D_MODEL)).astype(np.float32),
             w_out=(rng.standard_normal((E, F_E, D_MODEL)) / np.sqrt(F_E)).astype(np.float32),
             top_k=K)


def _run_group(world, tmp, inputs, also=()):
    """Start ``world`` ranks (and the processes in ``also``), wait for all,
    and return each rank's results."""
    out = tmp / f"world{world}"
    out.mkdir()
    store = tmp / f"store{world}"
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(world), str(r), str(store),
                               str(out), str(inputs)], env=_env(), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)] + list(also)
    errors = []
    for p in procs:
        _, err = p.communicate(timeout=240)
        if p.returncode:
            errors.append(err[-3000:])
    assert not errors, "\n".join(errors)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The 4-rank group with the reference's subprocess beside it, then the
    2-rank group: {"4": ranks' results, "2": ..., "reference": npz}."""
    tmp = tmp_path_factory.mktemp("a2a")
    inputs = tmp / "inputs.npz"
    _inputs(inputs)
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(inputs), str(tmp / "ref.npz")],
                           env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    four = _run_group(4, tmp, inputs, also=[ref])
    two = _run_group(2, tmp, inputs)
    return {"4": four, "2": two, "reference": dict(np.load(tmp / "ref.npz")),
            "inputs": dict(np.load(inputs))}


def _close(a, b, rtol=TOL, atol=TOL):
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_a2a_matches_the_dropless_moe(groups, shape):
    ranks = groups[str(shape[0] * shape[1])]
    for r in ranks:
        res = r[f"dropless{shape}"]
        assert res["experts"] == 4 // shape[1]          # reduced mixtral's 4 experts, split
        _close(res["y"], res["y_ref"])
        assert int(res["aux"]["dropped"]) == 0
        _close(res["aux"]["expert_load"], res["aux_ref"]["expert_load"], rtol=1e-6, atol=1e-7)
        _close(res["aux"]["moe_aux_loss"], res["aux_ref"]["moe_aux_loss"], rtol=1e-5, atol=1e-6)


def _kept_pairs(y, z):
    """(B, T, K) bool: for each token the subset of its K choices whose
    gate-weighted expert outputs (float64, from the npz's weights) sum to
    its row of ``y``; the best subset must fit far better than the next."""
    x = z["x"].astype(np.float64).reshape(-1, D_MODEL)
    logits = x @ z["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :K]
    gate = np.take_along_axis(probs, idx, -1)
    gate /= gate.sum(-1, keepdims=True)
    h = np.einsum("nd,nkdf->nkf", x, z["w_in"].astype(np.float64)[idx])
    h = h[..., :F_E] / (1 + np.exp(-h[..., :F_E])) * h[..., F_E:]
    c = gate[..., None] * np.einsum("nkf,nkfd->nkd", h, z["w_out"].astype(np.float64)[idx])
    subsets = np.array(list(product((0, 1), repeat=K)), dtype=np.float64)     # (2^K, K)
    fits = np.linalg.norm(y.reshape(-1, 1, D_MODEL).astype(np.float64)
                          - np.einsum("sk,nkd->nsd", subsets, c), axis=-1)      # (n, 2^K)
    order = np.sort(fits, axis=-1)
    assert (order[:, 0] < 1e-3).all() and (order[:, 1] > 1e-2).all(), order[:, :2]
    return subsets[fits.argmin(-1)].astype(bool).reshape(B, T, K)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_a2a_drops_the_references_pairs(groups, shape):
    ranks, z = groups["4"], groups["inputs"]
    y_ref = groups["reference"][str(shape)]
    blocks, dropped = {}, {}
    for r in ranks:
        res = r[f"drops{shape}"]
        d = res["data_rank"]
        if d in blocks:            # every model rank of a data rank holds the same y
            _close(res["y"], blocks[d], rtol=0, atol=0)
        blocks[d] = res["y"]
        dropped[d] = int(res["dropped"])
    y = torch.cat([blocks[d] for d in sorted(blocks)]).numpy()
    _close(torch.from_numpy(y), torch.from_numpy(y_ref))
    kept, kept_ref = _kept_pairs(y, z), _kept_pairs(y_ref, z)
    assert (kept == kept_ref).all()
    assert (~kept).sum() == sum(dropped.values()) > 0


def test_fallback_where_the_ranks_do_not_split_the_sequence(groups):
    for r in groups["2"]:
        res = r["fallback"]
        _close(res["y"], res["y_ref"])
        _close(res["aux"]["moe_aux_loss"], res["aux_ref"]["moe_aux_loss"], rtol=1e-5, atol=1e-6)
        assert "dropped" not in res["aux"]


def test_model_prefill_and_decode_through_a2a(groups):
    for r in groups["2"]:
        (logits, step), (logits_a2a, step_a2a) = r["serving"]["ragged"], r["serving"]["a2a"]
        _close(logits_a2a, logits)
        _close(step_a2a, step)


@pytest.mark.parametrize("seq", [16, 7])
def test_train_loss_gradients_through_a2a(groups, seq):
    for r in groups["2"]:
        res = r[f"train{seq}"]
        _close(res["loss"], res["loss_ref"], rtol=1e-6, atol=1e-6)
        assert len(res["grads"]) == len(res["grads_ref"])
        for name, g, e in zip(res["names"], res["grads"], res["grads_ref"]):
            assert g.shape == e.shape, name
            torch.testing.assert_close(g, e, rtol=1e-4, atol=1e-4 * float(e.abs().max()),
                                       msg=lambda m, name=name: f"{name}: {m}")
        assert any(n.endswith("moe/w_in") for n in res["names"])


def test_launcher_serves_on_cpu_ranks():
    """``launch.parallel`` as its CPU rehearsal runs it, with 4 ranks: the
    rank processes' prefills (all-to-all at the no-drop capacity and the
    config's 1.25) and decode (the fallback) against the dropless model."""
    from repro_torch.launch import parallel as ep
    args = ep.parse_args(["--arch", "mixtral_8x7b", "--reduced", "--device", "cpu",
                          "--dtype", "float32", "--ranks", "4", "--batch", "2",
                          "--prompt", "16"])
    ranks, ref = ep.launch(args), ep.reference(args)
    assert ep.capacity_factors(args) == [4.0, 1.25]
    assert not any(ep.check(args, ranks, ref, TOL).values())   # no kernel on the CPU
    assert [len(r["prefill"]) for r in ranks] == [2] * 4
    assert len(ep.summary(ranks, ref)) == 3


def test_launcher_keeps_attention_whole_past_the_kv_heads():
    """More expert-parallel ranks than KV heads, as qwen3_30b_a3b's 4 KV
    heads at 8 ranks: reduced, 4 query heads over 2 KV heads at 4 ranks.
    The query heads divide and the KV heads do not, so each rank holds one
    query head and, as the serve rules place them, a block of head_dim of
    both KV heads (in its weights and its cache): the attention is whole
    past the KV heads only once gathered, each rank's heads whole for K1
    and K2.  It cuts the experts (one each) and the vocabulary, and serves
    as the dropless model does."""
    from repro_torch.launch import parallel
    args = parallel.parse_args(["--arch", "qwen3_30b_a3b", "--reduced", "--device", "cpu", "--dtype",
                                "float32", "--ranks", "4", "--batch", "2", "--prompt", "16"])
    cfg = parallel.model_config(args)
    assert cfg.num_heads % 4 == 0 and cfg.num_kv_heads < 4
    ranks, ref = parallel.launch(args), parallel.reference(args)
    assert not any(parallel.check(args, ranks, ref, TOL).values())
    for r in ranks:
        assert r["params"]["blocks/attn/wq"][-2:] == (cfg.num_heads // 4, cfg.head_dim)
        assert (r["params"]["blocks/attn/wk"][-2:] == r["cache"]["layers/k"][-2:]
                == (cfg.num_kv_heads, cfg.head_dim // 4))
        assert r["params"]["blocks/moe/w_in"][1] == 1
        assert r["params"]["embed"][0] == cfg.vocab_size // 4


def test_fallback_without_a_mesh():
    """No ambient mesh: ``moe_a2a`` is ``moe``, and an a2a model builds and
    runs the dropless MoE."""
    cfg = get_reduced_config("mixtral_8x7b")
    p = L.moe_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    assert mesh.ambient_mesh() is None
    y, aux = L.moe_a2a(cfg, p, x)
    y_ref, aux_ref = L.moe(cfg, p, x)
    assert torch.equal(y, y_ref) and torch.equal(aux["expert_load"], aux_ref["expert_load"])


class _FakeMesh:
    """What ``shard_params`` reads of a device mesh: the "model" coordinate,
    at a "data" size of 1."""
    mesh_dim_names = ("data", "model")

    def __init__(self, m, n):
        self.sub = type("Sub", (), {"get_local_rank": lambda _: m, "size": lambda _: n})()
        self.data = type("Sub", (), {"get_local_rank": lambda _: 0, "size": lambda _: 1})()

    def __getitem__(self, name):
        return self.data if name == "data" else self.sub


def test_shard_params_cuts_only_the_experts():
    """``shard_params`` at each "model" coordinate: the experts' blocks in
    order, the router the same tensor; E % ep keeps them whole (at 3 ranks
    the serve rules place nothing of reduced mixtral on "model")."""
    cfg = get_reduced_config("mixtral_8x7b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    w_in = params["blocks"]["moe"]["w_in"]
    parts = [mesh.shard_params(params, _FakeMesh(m, 2)) for m in range(2)]
    assert torch.equal(torch.cat([p["blocks"]["moe"]["w_in"] for p in parts], dim=1), w_in)
    assert all(p["blocks"]["moe"]["router"] is params["blocks"]["moe"]["router"] for p in parts)
    assert mesh.shard_params(params, _FakeMesh(0, 3))["blocks"]["moe"]["w_in"] is w_in


def test_moe_impl_is_validated():
    cfg = get_reduced_config("mixtral_8x7b")
    build_model(cfg.replace(moe_impl="a2a"))
    with pytest.raises(ValueError, match="moe_impl"):
        build_model(cfg.replace(moe_impl="dense"))
