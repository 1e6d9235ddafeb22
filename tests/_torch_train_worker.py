"""One rank of ``tests/test_torch_train_mesh.py``: a CPU process in a gloo group.

    python tests/_torch_train_worker.py WORLD RANK STORE OUT CASES

WORLD ranks join the group through the ``FileStore`` at STORE (no TCP port,
so parallel test workers cannot collide).  CASES is a file of
``torch.save``'d cases, each a config, a whole parameter tree (from the JAX
model through the bridge), the batches of its steps (an encoder-decoder's
with its frames), the mesh's ("data", "model") or ("pod", "data", "model")
sizes, whose product is WORLD, the microbatches and the optimizer's
config.  For each case the rank cuts its blocks by the "train"
rules (``launch.mesh.shard_params(..., mode="train")``), builds the
``Sharding`` of its mesh (``launch.mesh.train_sharding``), and trains
through ``make_train_step`` on the whole batch (it takes its rows).  It
saves its blocks' shapes, each step's loss and grad_norm, its block of step
1's gradients and of the parameters after the steps, its mesh coordinates,
the bytes it gathered and reduced over "data" and each step's product FLOPs
and collective census (``launch.rank_cost.measure``) to OUT/rank<RANK>.pt.
It imports torch and the port only.
"""

import sys

import torch
import torch.distributed as dist

from repro_torch.launch import mesh
from repro_torch.launch.rank_cost import measure
from repro_torch.models import layers
from repro_torch.models.optim import init_adamw, make_train_step, tree_map
from repro_torch.models.transformer import build_model


def train(case):
    sizes = case["mesh"]
    dm = mesh.device_mesh(mesh.MeshAxes(("pod", "data", "model")[-len(sizes):], sizes), "cpu")
    with mesh.use_mesh(dm):
        model = build_model(case["cfg"])
        # a copy: cases may share one tree, and a leaf the rank holds whole
        # is the tree's own tensor, which the steps update in place
        params = mesh.shard_params(tree_map(lambda p: p.clone(), case["params"]), dm,
                                   mode="train")
        sharding = mesh.train_sharding(case["params"], dm)
        opt = init_adamw(params)
        step = make_train_step(model, case["opt"], microbatches=case["microbatches"],
                               sharding=sharding)
        losses, norms, step1 = [], [], None

        def keep(grads):
            nonlocal step1
            step1 = tree_map(lambda g: g.detach().clone(), grads)

        layers.GATHERED.clear()
        layers.REDUCED.clear()
        census = []
        for batch in case["batches"]:
            out = []
            census.append(measure(lambda: out.append(
                step(params, opt, batch, on_grads=keep if step1 is None else None))))
            metrics = out[0][2]
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    return {"shapes": {name: tuple(leaf.shape) for name, leaf in mesh.leaves_with_names(params)},
            "losses": losses, "norms": norms, "grads": step1,
            "final": tree_map(lambda p: p.detach().clone(), params),
            "coords": (sharding.rank, mesh.model_coordinate(dm)[0]),
            "gathered": layers.GATHERED["fsdp"], "reduced": sum(layers.REDUCED.values()),
            "census": census}


def main(world, rank, store, out, cases):
    torch.set_num_threads(1 if world > 4 else 2)    # 8 ranks: one thread each
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    res = {name: train(case) for name, case in torch.load(cases, weights_only=False).items()}
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    w, r, s, o, c = sys.argv[1:]
    main(int(w), int(r), s, o, c)
