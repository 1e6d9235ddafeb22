"""One rank of ``tests/test_torch_moe_a2a.py``: a CPU process in a gloo group.

    python tests/_torch_moe_a2a_worker.py WORLD RANK STORE OUT INPUTS

WORLD ranks join the group through the ``FileStore`` at STORE (no TCP port,
so parallel test workers cannot collide).  Four ranks run the expert-parallel
MoE at meshes (1, 4) and (2, 2); two ranks at (1, 2), plus the fallback,
the model's serving path and ``train_loss``.  Each rank saves what it
computed to OUT/rank<RANK>.pt for the test to compare; INPUTS is the npz of
the capacity-drop case, which the reference's ``moe_a2a`` reads too.  It
imports torch and the port only.
"""

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced_config
from repro_torch.launch import mesh
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.optim import tree_leaves, tree_map, value_and_grad
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)


def no_drops(cfg):
    """``cfg`` with room for every pair on one rank: nothing drops."""
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def make_mesh(shape):
    return mesh.device_mesh(mesh.MeshAxes(("data", "model"), shape), "cpu")


def data_block(dm, x):
    """This rank's data block of a batch the "data" axis divides."""
    sub = dm["data"]
    return x.chunk(sub.size(), 0)[sub.get_local_rank()]


def against_dropless(shape):
    """moe_a2a against the dropless moe on this rank's data block, reduced
    mixtral's MoE at a capacity that drops nothing."""
    cfg = no_drops(get_reduced_config("mixtral_8x7b"))
    full = {"moe": L.moe_params(cfg, torch.Generator().manual_seed(0), torch.float32)}
    x = torch.randn((4, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    dm = make_mesh(shape)
    x = data_block(dm, x)
    with mesh.use_mesh(dm):
        y, aux = L.moe_a2a(cfg, mesh.shard_params(full)["moe"], x)
    y_ref, aux_ref = L.moe(cfg, full["moe"], x)
    return {"y": y, "y_ref": y_ref, "aux": aux, "aux_ref": aux_ref,
            "experts": mesh.shard_params(full, dm)["moe"]["w_in"].shape[0]}


def with_drops(shape, inputs):
    """moe_a2a at capacity_factor 1.0 on the npz's inputs and weights."""
    z = np.load(inputs)
    E, F = z["w_out"].shape[:2]
    cfg = ModelConfig(arch_id="moe_test", family="moe", num_layers=1, d_model=z["x"].shape[-1],
                      num_heads=4, num_kv_heads=4, d_ff=F, vocab_size=256, head_dim=16,
                      moe=MoEConfig(num_experts=E, top_k=int(z["top_k"]), d_ff_expert=F,
                                    capacity_factor=1.0))
    full = {"moe": {k: torch.from_numpy(z[k]) for k in ("router", "w_in", "w_out")}}
    dm = make_mesh(shape)
    with mesh.use_mesh(dm):
        y, aux = L.moe_a2a(cfg, mesh.shard_params(full)["moe"], data_block(dm, torch.from_numpy(z["x"])))
    return {"y": y, "dropped": aux["dropped"], "data_rank": dm["data"].get_local_rank()}


def fallback():
    """T % ep: the dropless MoE on the sharded experts."""
    cfg = get_reduced_config("mixtral_8x7b")
    full = {"moe": L.moe_params(cfg, torch.Generator().manual_seed(2), torch.float32)}
    x = torch.randn((2, 7, cfg.d_model), generator=torch.Generator().manual_seed(3))
    with mesh.use_mesh(make_mesh((1, 2))):
        y, aux = L.moe_a2a(cfg, mesh.shard_params(full)["moe"], x)
    y_ref, aux_ref = L.moe(cfg, full["moe"], x)
    return {"y": y, "y_ref": y_ref, "aux": aux, "aux_ref": aux_ref}


def serving():
    """Reduced mixtral with moe_impl="a2a" against the dropless model on the
    same weights: a 16-token prefill (the a2a path in every layer) and a
    decode (the fallback).  The a2a model runs on the ranks' blocks (its
    attention on each rank's heads, its cache of those KV heads), the
    dropless model on the whole weights under the same mesh."""
    cfg = no_drops(get_reduced_config("mixtral_8x7b"))
    out = {}
    for impl in ("ragged", "a2a"):
        model = build_model(cfg.replace(moe_impl=impl))
        params = model.init(torch.Generator().manual_seed(4), torch.float32, "cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(5))
        with mesh.use_mesh(make_mesh((1, 2))), torch.no_grad():
            if impl == "a2a":
                params = mesh.shard_params(params)
            cache = model.init_cache(2, 32, torch.float32, "cpu", params=params)
            logits, cache = model.prefill(params, {"tokens": tokens}, cache)
            step, _ = model.decode_step(params, cache, tokens[:, -1:])
        out[impl] = (logits, step)
    return out


def training(seq):
    """``value_and_grad`` of reduced mixtral's ``train_loss`` through moe_a2a
    (``seq`` 16: the all-to-all path; 7: the fallback) at a capacity that
    drops nothing, against the dropless model: the loss, and each rank's
    gradients (router summed over "model"), with the dropless gradients of
    this rank's experts."""
    cfg = no_drops(get_reduced_config("mixtral_8x7b"))
    g = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (2, seq + 1), generator=g)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    ref_model = build_model(cfg)
    params = ref_model.init(torch.Generator().manual_seed(7), torch.float32, "cpu")
    loss_ref, _, grads = value_and_grad(ref_model, params, batch)
    grads_ref = tree_map(lambda t: t.detach().clone(), grads)
    dm = make_mesh((1, 2))
    with mesh.use_mesh(dm):
        local = mesh.shard_params(tree_map(lambda t: t.detach().clone(), params))
        loss, _, grads = value_and_grad(build_model(cfg.replace(moe_impl="a2a")), local, batch)
        expected = mesh.shard_params(grads_ref)
    return {"loss": loss, "loss_ref": loss_ref,
            "grads": [t.detach().clone() for t in tree_leaves(grads)],
            "grads_ref": list(tree_leaves(expected)),
            "names": [n for n, _ in mesh.leaves_with_names(grads)]}


def main(world, rank, store, out, inputs):
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    res = {}
    if world == 4:
        for shape in ((1, 4), (2, 2)):
            res[f"dropless{shape}"] = against_dropless(shape)
            res[f"drops{shape}"] = with_drops(shape, inputs)
    else:
        res["dropless(1, 2)"] = against_dropless((1, 2))
        res["fallback"] = fallback()
        res["serving"] = serving()
        res["train16"] = training(16)
        res["train7"] = training(7)
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    w, r, s, o, i = sys.argv[1:]
    main(int(w), int(r), s, o, i)
