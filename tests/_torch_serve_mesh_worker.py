"""One rank of ``tests/test_torch_serve_mesh.py``: a CPU process in a gloo group.

    python tests/_torch_serve_mesh_worker.py WORLD RANK STORE OUT CASES

WORLD ranks join the group through the ``FileStore`` at STORE (no TCP port,
so parallel test workers cannot collide).  CASES is a file of
``torch.save``'d cases, each a config, a whole parameter tree (from the JAX
model through the bridge), the mesh's axis names and sizes (their product
is WORLD), prompts, the lengths of the prompt's prefill chunks, the
decodes' tokens and the cache size, and optionally ``seq_shard`` (the
reference's ``kv_seq_shard``) and an encoder-decoder's ``frames`` (B, F, d).
For each case the rank builds the
mesh (``launch.mesh.device_mesh``), cuts its blocks by the serve rules
(``launch.mesh.shard_params``: the MoE experts' d over the batch axes
among them), builds the cache of its blocks (``init_cache(..., params=)``
under the mesh: its rows, or its block of the KV sequence over "data" or,
with ``seq_shard``, over "model", and of the frames), prefills its rows of
the prompts (``launch.mesh.batch_rows``: every row where the batch axes do
not divide the batch) chunk by chunk, the frames with the first, and
decodes the fed tokens of those rows through ``decode_slots``.  It saves its leaves' and cache's
shapes, its coordinates, its rows, the logits after each chunk and each
decode, its cache's values after the prefill and after the decodes, the
bytes it gathered (``layers.GATHERED``), each chunk's and each decode's
product FLOPs and collective census (``launch.rank_cost.measure``) and how
many experts each gather of the experts' d took (``layers.EXPERTS_KEPT``)
to OUT/rank<RANK>.pt.  It imports torch and the port only.
"""

import sys

import torch
import torch.distributed as dist

from repro_torch.launch import mesh
from repro_torch.launch.rank_cost import measure
from repro_torch.models import layers
from repro_torch.models.transformer import build_model


def serve(case):
    axes = mesh.MeshAxes(*case["mesh"])
    dm = mesh.device_mesh(axes, "cpu")
    prompt, fed = case["prompt"], case["fed"]
    B = prompt.shape[0]
    with mesh.use_mesh(dm), torch.no_grad():
        model = build_model(case["cfg"])
        params = mesh.shard_params(case["params"])
        frames = case.get("frames")
        extra = {} if frames is None else {"enc_frames": frames.shape[1]}
        cache = model.init_cache(B, case["cache_size"], torch.float32, "cpu", params=params,
                                 seq_shard=case.get("seq_shard", False), **extra)
        rows = mesh.batch_rows(B)
        mine = torch.arange(rows.stop - rows.start)
        layers.GATHERED.clear()
        layers.EXPERTS_KEPT.clear()
        logits, census, s0 = [], [], 0
        for n in case["chunks"]:
            inputs = {"tokens": prompt[rows, s0:s0 + n]}
            if frames is not None and s0 == 0:
                inputs["frontend_embeds"] = frames[rows]
            census.append(measure(lambda: logits.append(model.prefill(params, inputs, cache)[0])))
            s0 += n
        kept = [_values(cache)]
        for t in range(fed.shape[0]):
            census.append(measure(
                lambda: logits.append(model.decode_slots(params, cache, fed[t][rows], mine))))
        kept.append(_values(cache))
    shapes = {what: {name: tuple(leaf.shape) for name, leaf in mesh.leaves_with_names(tree)}
              for what, tree in (("params", params), ("cache", cache))}
    return dict(shapes, logits=logits, cache_values=kept, rows=(rows.start, rows.stop),
                gathered=dict(layers.GATHERED), census=census,
                experts_kept=list(layers.EXPERTS_KEPT), block=cache.get("seq_block"),
                cross_block=cache.get("cross_block"),
                coords={a: dm[a].get_local_rank() for a in axes.names})


def _values(cache):
    return {name: leaf.clone() for name, leaf in mesh.leaves_with_names(cache)}


def main(world, rank, store, out, cases):
    torch.set_num_threads(1 if world > 2 else 2)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    res = {name: serve(case) for name, case in torch.load(cases, weights_only=False).items()}
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    w, r, s, o, c = sys.argv[1:]
    main(int(w), int(r), s, o, c)
