"""One rank of ``tests/test_torch_tensor_parallel.py`` and ``tests/test_torch_tp_fallback.py``: a CPU process in a gloo group.

    python tests/_torch_tp_worker.py WORLD RANK STORE OUT CASES

WORLD ranks join the group through the ``FileStore`` at STORE (no TCP port,
so parallel test workers cannot collide) on a ("data", "model") mesh of
(1, WORLD).  CASES is a file of ``torch.save``'d cases, each a config, a
whole parameter tree (from the JAX model through the bridge), prompts and
the decodes' tokens, and for an encoder-decoder the frame embeddings; a
case may give ``chunks``, the lengths of the prompt's prefill chunks (the
whole prompt at once by default).  For each case the rank cuts its blocks
(``launch.mesh.shard_params``), builds the cache of their blocks
(``init_cache(..., params=)``), prefills the prompts chunk by chunk (after
the frames) and decodes the case's fed tokens of every row through
``decode_slots``, and saves its leaves' and cache's shapes, its logits
after each chunk and each decode and the bytes it gathered
(``layers.GATHERED``) to OUT/rank<RANK>.pt; a case with ``keep_cache``
also saves the cache's values after the prefill and after the decodes.
It imports torch and the port only.
"""

import sys

import torch
import torch.distributed as dist

from repro_torch.launch import mesh
from repro_torch.models import layers
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)


def serve(case, world):
    dm = mesh.device_mesh(mesh.MeshAxes(("data", "model"), (1, world)), "cpu")
    prompt, fed = case["prompt"], case["fed"]
    rows = torch.arange(prompt.shape[0])
    with mesh.use_mesh(dm), torch.no_grad():
        model = build_model(case["cfg"])
        params = mesh.shard_params(case["params"])
        inputs, extra = {"tokens": prompt}, {}
        if "frames" in case:
            inputs["frontend_embeds"] = case["frames"]
            extra["enc_frames"] = case["frames"].shape[1]
        cache = model.init_cache(prompt.shape[0], case["cache_size"], torch.float32, "cpu",
                                 params=params, **extra)
        layers.GATHERED.clear()
        logits, s0 = [], 0
        for n in case.get("chunks", [prompt.shape[1]]):
            inputs["tokens"] = prompt[:, s0:s0 + n]
            logits.append(model.prefill(params, inputs, cache)[0])
            inputs.pop("frontend_embeds", None)
            s0 += n
        kept = [_values(cache)] if case.get("keep_cache") else []
        for t in range(fed.shape[0]):
            logits.append(model.decode_slots(params, cache, fed[t], rows))
    shapes = {what: {name: tuple(leaf.shape) for name, leaf in mesh.leaves_with_names(tree)}
              for what, tree in (("params", params), ("cache", cache))}
    if kept:
        kept.append(_values(cache))
    return dict(shapes, logits=logits, gathered=dict(layers.GATHERED), cache_values=kept)


def _values(cache):
    return {name: leaf.clone() for name, leaf in mesh.leaves_with_names(cache)}


def main(world, rank, store, out, cases):
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    res = {name: serve(case, world)
           for name, case in torch.load(cases, weights_only=False).items()}
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    w, r, s, o, c = sys.argv[1:]
    main(int(w), int(r), s, o, c)
