"""Serving over "model" ranks: tensor parallelism, and expert parallelism for an MoE.

    PYTHONPATH=src python -m repro_torch.launch.parallel \\
        --arch llama3_70b --layers 16 --ranks 4 --batch 4 --prompt 256 --decodes 4
    PYTHONPATH=src python -m repro_torch.launch.parallel \\
        --arch qwen3_30b_a3b --layers 8 --ranks 2 --batch 4 --prompt 512

It starts ``--ranks`` processes of itself, which meet in a gloo group
through a ``FileStore`` in a temporary directory, on a ("data", "model")
mesh of (1, ranks).  Each rank builds only its blocks of the model from
seed 0 (``launch.mesh.build_params``: each leaf that the serve rules place
on "model" — the attention's heads, the MLP's F, the embeddings'
vocabulary, the MoE's experts — drawn whole as the one-process model draws
it and cut to the rank's block at once; an MoE's attention whose K/V do not
split on heads, and experts that do not divide, stay whole, as
``launch.mesh.model_placements`` says) and the cache of its blocks' KV heads
(``init_cache(..., params=)``), then prefills ``--batch`` prompts of
``--prompt`` random tokens (numpy seed 0) into the fresh cache and decodes
``--decodes`` more tokens (drawn after the prompts) through
``decode_slots``.  The dense layers run Megatron's split
(``models.layers``): a rank's query heads over their KV heads, K1 and K2 on
those heads; the attention's and the MLP's partial outputs reduced over
"model" in fp32; the vocabulary's logits gathered.  An MoE model also runs
``moe_impl="a2a"`` and prefills once more into a fresh cache for each
capacity factor (:func:`capacity_factors`): a prefill runs
``layers.moe_a2a`` in every MoE layer (the all-to-all: the ranks split the
sequence), a decode its dropless fallback on the sharded experts.

Each rank saves its logits at every step, the milliseconds of its prefills
and decodes (the host's clock, the device synchronised), each MoE layer's
milliseconds and dropped pairs, its kernel launch counts, its leaves' and
cache's shapes and, on the card, the bytes its parameters and its cache
hold (``torch.cuda.memory_allocated()`` grown by building each).  The
launcher then runs :func:`reference`, prints :func:`summary` and applies
:func:`check`; it exits non-zero if a rank fails or a check does.

On one card every rank runs on it (``cuda`` is device ``rank % count``):
NCCL refuses two ranks on one device, and gloo moves the collectives'
bytes through host memory while the layers stay on the card.  Times taken
so are of ranks sharing one card, not of several cards.

:func:`reference` serves the same tokens through the one-process model
(the dropless MoE for an MoE) on the same weights, the reference the ranks
are held against.

CPU rehearsal (``--config`` overrides a field of the config)::

    PYTHONPATH=src python -m repro_torch.launch.parallel --arch llama3_70b --reduced \\
        --config num_heads=8 --config num_kv_heads=4 --device cpu --dtype float32 \\
        --ranks 4 --batch 2 --prompt 16 --decodes 3
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

SEED = 0            # the weights' generator and the tokens' numpy seed
TIMEOUT = 600.0     # seconds for all ranks to finish
ALLOC_BLOCK = 512   # the CUDA caching allocator rounds each tensor up to this
ALLOC_UNSPLIT = 1 << 20   # and leaves up to this much of a larger block unsplit with it


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3_30b_a3b")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this (0: all)")
    ap.add_argument("--config", action="append", default=[], metavar="FIELD=INT",
                    help="set an integer field of the config (repeatable)")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--decodes", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def model_config(args: argparse.Namespace, moe_impl: str = "a2a", capacity_factor=None):
    """The served config: ``--arch`` (reduced), cut to ``--layers``, with
    the ``--config`` fields set; an MoE's with ``moe_impl`` and, where
    given, ``capacity_factor``."""
    from repro_torch.configs import get_config, get_reduced_config
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers, layer_pattern=None)
    if args.config:
        cfg = cfg.replace(**{k: int(v) for k, v in (kv.split("=", 1) for kv in args.config)})
    if cfg.moe is None:
        return cfg
    moe = cfg.moe if capacity_factor is None else dataclasses.replace(
        cfg.moe, capacity_factor=float(capacity_factor))
    return cfg.replace(moe_impl=moe_impl, moe=moe)


def capacity_factors(args: argparse.Namespace) -> List[Optional[float]]:
    """An MoE's: the ranks' count, at which a destination has room for all
    of a rank's pairs (cap = n_loc·K: nothing drops), and the config's own;
    a dense model's one prefill has none."""
    cfg = model_config(args)
    if cfg.moe is None:
        return [None]
    return [float(args.ranks), cfg.moe.capacity_factor]


def tokens(args: argparse.Namespace, vocab: int, device):
    """The prompts (batch, prompt) and the decodes' tokens (decodes, batch,
    1), from numpy seed 0 in that order."""
    import torch
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(1, vocab, size=(args.batch, args.prompt), dtype=np.int64)
    fed = rng.integers(1, vocab, size=(args.decodes, args.batch, 1), dtype=np.int64)
    return torch.from_numpy(prompt).to(device), torch.from_numpy(fed).to(device)


def cache_len(args: argparse.Namespace) -> int:
    return -(-(args.prompt + args.decodes) // 16) * 16


@contextlib.contextmanager
def moe_timing(device):
    """Record each MoE block's milliseconds (host clock around the call,
    the device synchronised before and after) and its ``dropped`` count
    while the block runs: ``layers.moe`` and ``layers.moe_a2a``, which the
    model looks up at each call, are wrapped and restored after."""
    from repro_torch.models import layers as L
    calls: List[Dict] = []
    depth = [0]

    def wrap(fn):
        def timed(cfg, p, x, **kw):
            if depth[0]:                    # a fallback inside a timed call
                return fn(cfg, p, x, **kw)
            depth[0] += 1
            _sync(device)
            t0 = time.perf_counter()
            try:
                y, aux = fn(cfg, p, x, **kw)
                _sync(device)
            finally:
                depth[0] -= 1
            calls.append({"fn": fn.__name__, "ms": (time.perf_counter() - t0) * 1e3,
                          "dropped": int(aux["dropped"]) if "dropped" in aux else None})
            return y, aux
        return timed

    originals = L.moe, L.moe_a2a
    L.moe, L.moe_a2a = wrap(L.moe), wrap(L.moe_a2a)
    try:
        yield calls
    finally:
        L.moe, L.moe_a2a = originals


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _allocated(device) -> int:
    import torch
    _sync(device)
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def _shapes(tree) -> Dict[str, tuple]:
    from repro_torch.launch.mesh import leaves_with_names
    return {name: tuple(leaf.shape) for name, leaf in leaves_with_names(tree)}


def _serve(args, cfg_of, params, device, dtype) -> Dict:
    """Prefill and decode once untimed, then prefill the prompts once for
    each capacity factor into a fresh cache (the model of ``cfg_of(cf)``),
    and decode ``--decodes`` tokens of every row through ``decode_slots``
    after the first.  Returns {"prefill": [{"cf", "logits", "moe",
    "launches", "ms"}], "decode": {"logits": [...], "ms": [...], "moe",
    "launches"}, "cache": the first cache's leaf shapes, "cache_bytes"}."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import build_model
    out: Dict = {"prefill": []}
    cf_list = capacity_factors(args)
    prompt, fed = tokens(args, cfg_of(cf_list[0]).vocab_size, device)
    rows = torch.arange(args.batch, device=device)
    with torch.no_grad():                    # a warm-up, so that no timed call is a first one
        model = build_model(cfg_of(cf_list[0]))
        cache = model.init_cache(args.batch, cache_len(args), dtype, device, params=params)
        model.prefill(params, {"tokens": prompt}, cache)
        model.decode_slots(params, cache, fed[0], rows)
        del cache
    for i, cf in enumerate(cf_list):
        model = build_model(cfg_of(cf))
        before = _allocated(device)
        cache = model.init_cache(args.batch, cache_len(args), dtype, device, params=params)
        if i == 0:
            out.update(cache=_shapes(cache), cache_bytes=_allocated(device) - before)
        ops.reset_launch_counts()
        with torch.no_grad(), moe_timing(device) as calls:
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": prompt}, cache)
            _sync(device)
            ms = (time.perf_counter() - t0) * 1e3
        out["prefill"].append({"cf": cf, "logits": logits.float().cpu(), "moe": calls,
                               "launches": ops.launch_counts(), "ms": ms})
        if i == 0:
            steps, step_ms = [], []
            ops.reset_launch_counts()
            with torch.no_grad(), moe_timing(device) as calls:
                for t in range(args.decodes):
                    t0 = time.perf_counter()
                    step = model.decode_slots(params, cache, fed[t], rows)
                    _sync(device)
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    steps.append(step.float().cpu())
            out["decode"] = {"logits": steps, "ms": step_ms, "moe": calls,
                             "launches": ops.launch_counts()}
        del cache
    return out


def _device(args, rank: int = 0):
    import torch
    from repro_torch.core.device import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def reference(args: argparse.Namespace) -> Dict:
    """The tokens through the one-process model (an MoE's dropless,
    ``moe_impl="ragged"``) on the weights every rank builds its blocks of:
    what :func:`launch`'s ranks are held against."""
    import torch

    from repro_torch.models.transformer import build_model
    device = _device(args)
    dtype = getattr(torch, args.dtype)
    cfg = model_config(args, "ragged")
    params = build_model(cfg).init(torch.Generator(device).manual_seed(SEED), dtype)
    return _serve(args, lambda cf: model_config(args, "ragged", cf), params, device, dtype)


def run_rank(args: argparse.Namespace) -> None:
    """One rank: join the group, build its blocks of the model, serve, save."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh
    from repro_torch.models.transformer import build_model
    if args.device == "cpu":
        torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(args.store, args.ranks),
                            rank=args.rank, world_size=args.ranks)
    try:
        device = _device(args, args.rank)
        dtype = getattr(torch, args.dtype)
        dm = mesh.device_mesh(mesh.MeshAxes(("data", "model"), (1, args.ranks)), device.type)
        with mesh.use_mesh(dm):
            model = build_model(model_config(args))
            before = _allocated(device)
            t0 = time.perf_counter()
            # raises for a placement no layer runs (model_placements)
            params = mesh.build_params(model, torch.Generator(device).manual_seed(SEED), dtype)
            param_bytes = _allocated(device) - before
            built = time.perf_counter() - t0
            if device.type == "cuda":
                torch.cuda.empty_cache()      # the whole leaves' blocks, for the other ranks
            res = _serve(args, lambda cf: model_config(args, "a2a", cf), params, device, dtype)
        res.update(rank=args.rank, build_seconds=built, params=_shapes(params),
                   param_bytes=param_bytes,
                   memory=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        torch.save(res, Path(args.out) / f"rank{args.rank}.pt")
    finally:
        dist.destroy_process_group()


def launch(args: argparse.Namespace) -> List[Dict]:
    """Start ``args.ranks`` rank processes, wait for all of them, and return
    each rank's results; raises if one fails (the others are stopped)."""
    import torch
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        out = Path(tmp)
        env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")       # every rank is on this host
        src = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        base = [sys.executable, "-m", "repro_torch.launch.parallel",
                "--arch", args.arch, "--layers", str(args.layers), "--ranks", str(args.ranks),
                "--batch", str(args.batch), "--prompt", str(args.prompt),
                "--decodes", str(args.decodes), "--device", args.device, "--dtype", args.dtype,
                "--out", str(out), "--store", str(out / "store")]
        base += (["--reduced"] if args.reduced else []) + [
            a for kv in args.config for a in ("--config", kv)]
        procs = [subprocess.Popen(base + ["--rank", str(r)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(args.ranks)]
        deadline = time.monotonic() + TIMEOUT
        failed = []
        try:
            for r, p in enumerate(procs):
                try:
                    text, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    text, _ = p.communicate()
                    failed.append(f"rank {r} timed out after {TIMEOUT:.0f} s")
                if p.returncode:
                    failed.append(f"rank {r} exited {p.returncode}:\n{text[-4000:]}")
                    for q in procs:             # a rank that fails leaves its peers waiting
                        if q.poll() is None:
                            q.kill()
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        if failed:
            raise RuntimeError("ranks failed:\n" + "\n".join(failed))
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(args.ranks)]


def _rel(got, exp) -> float:
    return float((got - exp).abs().max() / exp.abs().max())


def summary(ranks: List[Dict], ref: Dict) -> List[str]:
    """One line per prefill and one for the decodes: each rank's
    milliseconds and the one-process model's, an MoE's dropped pairs and
    MoE layers' milliseconds, and the logits' largest distance from the
    one-process model's, relative to its largest."""
    lines = []
    for i, pre in enumerate(ranks[0]["prefill"]):
        ref_pre = ref["prefill"][i]
        line = (f"prefill{'' if pre['cf'] is None else ' at capacity_factor ' + str(pre['cf'])}: "
                f"ms by rank {[round(r['prefill'][i]['ms'], 3) for r in ranks]}, one process "
                f"{ref_pre['ms']:.3f}; logits {_rel(pre['logits'], ref_pre['logits']):.3e} "
                "from the one-process model's")
        if pre["moe"]:
            dropped = sum(c["dropped"] or 0 for c in pre["moe"])
            moe_ms = [round(sum(c["ms"] for c in r["prefill"][i]["moe"]), 3) for r in ranks]
            line += (f"; {dropped} (token, choice) pairs dropped over {len(pre['moe'])} MoE "
                     f"layers; MoE ms by rank {moe_ms}, dropless "
                     f"{sum(c['ms'] for c in ref_pre['moe']):.3f}")
        lines.append(line)
    dec, ref_dec = ranks[0]["decode"], ref["decode"]
    worst = max((_rel(g, e) for g, e in zip(dec["logits"], ref_dec["logits"])), default=0.0)
    line = (f"{len(dec['ms'])} decodes: ms by rank "
            f"{[[round(ms, 3) for ms in r['decode']['ms']] for r in ranks]}, one process "
            f"{[round(ms, 3) for ms in ref_dec['ms']]}; logits at most {worst:.3e} from the "
            "one-process model's")
    if dec["moe"]:
        line += (f"; MoE ms by rank "
                 f"{[round(sum(c['ms'] for c in r['decode']['moe']), 3) for r in ranks]}")
    lines.append(line)
    return lines


def expected(args: argparse.Namespace):
    """What a rank must hold: ({leaf: shape} of its parameters and of its
    cache, and the bytes of each tensor), from the whole trees on the meta
    device: each leaf the :func:`~repro_torch.launch.mesh.shard_shape` of its
    serve placement at a (1, ranks) mesh, or whole where
    :func:`~repro_torch.launch.mesh.model_placements` keeps it whole (an
    expert-parallel model's attention whose K/V do not split on heads, and
    then the cache's K/V too)."""
    import torch

    from repro_torch.launch import mesh
    from repro_torch.models.transformer import build_model
    axes = mesh.MeshAxes(("data", "model"), (1, args.ranks))
    dtype = getattr(torch, args.dtype)
    with mesh.use_mesh(None):
        model = build_model(model_config(args))
        params = model.init(torch.Generator().manual_seed(0), dtype, device="meta")
        cache = model.init_cache(args.batch, cache_len(args), dtype, device="meta")
    dims = mesh.model_placements(params, args.ranks)
    kv_split = any(dims[n] is not None for n in dims if n.endswith("attn/wk"))
    whole = {"params": {n for n, d in dims.items() if d is None},
             "cache": {n for n, _ in mesh.leaves_with_names(cache)
                       if not kv_split and n.rsplit("/", 1)[-1] in ("k", "v")}}
    out = []
    for what, tree, specs in (("params", params, mesh.param_specs(params, axes, "serve")),
                              ("cache", cache, mesh.cache_specs(cache, axes, batch=args.batch))):
        spec_of = mesh.named_specs(specs)
        shapes = {name: tuple(leaf.shape) if name in whole[what] else
                  mesh.shard_shape(tuple(leaf.shape), spec_of[name], axes)
                  for name, leaf in mesh.leaves_with_names(tree)}
        sizes = [int(np.prod(shapes[name])) * leaf.element_size()
                 for name, leaf in mesh.leaves_with_names(tree)]
        out.append((shapes, sizes))
    return out


def allocation_bounds(sizes: List[int]):
    """What ``torch.cuda.memory_allocated()`` grows by for tensors of
    ``sizes`` bytes: each rounded up to ALLOC_BLOCK, and each of over
    ALLOC_UNSPLIT up to ALLOC_UNSPLIT more, of a block the caching
    allocator does not split.  Returns (least, most)."""
    rounded = [max(ALLOC_BLOCK, -(-n // ALLOC_BLOCK) * ALLOC_BLOCK) for n in sizes]
    return sum(rounded), sum(rounded) + ALLOC_UNSPLIT * sum(n > ALLOC_UNSPLIT for n in rounded)


def check(args: argparse.Namespace, ranks: List[Dict], ref: Dict, tol: float) -> collections.Counter:
    """Raise unless the ranks served as they should: each holds its blocks
    of the parameters and of the cache (the shapes of its placements; on the
    card, the allocation's bytes within :func:`allocation_bounds` of them);
    every prefill ran, on the card, K1 once an attention layer, and the
    decodes K2 once an attention layer a decode; the ranks' logits agree
    (1e-6 of the largest) at every step; the prefill's logits (an MoE's at
    the first capacity factor, where nothing may drop, and through
    ``moe_a2a`` in every layer) and every decode's lie within ``tol`` of the
    one-process model's, relative to its largest, finite and of shape
    (batch, vocab).  Returns the ranks' kernel launches, summed."""
    import torch
    cfg = model_config(args)
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_pattern)
    cuda = args.device != "cpu"
    (p_shapes, p_sizes), (c_shapes, c_sizes) = expected(args)
    launches: collections.Counter = collections.Counter()
    for r in ranks:
        who = f"rank {r['rank']}"
        for what, got, exp in (("parameters", r["params"], p_shapes), ("cache", r["cache"], c_shapes)):
            if got != exp:
                wrong = {n: (got.get(n), exp.get(n)) for n in set(got) | set(exp)
                         if got.get(n) != exp.get(n)}
                raise AssertionError(f"{who}'s {what} are not its blocks: {wrong}")
        if cuda:
            for what, got, sizes in (("parameters", r["param_bytes"], p_sizes),
                                     ("cache", r["cache_bytes"], c_sizes)):
                least, most = allocation_bounds(sizes)
                if not least <= got <= most:
                    raise AssertionError(f"{who}'s {what} allocated {got} bytes, not "
                                         f"{sum(sizes)} rounded ({least} .. {most})")
        for i, pre in enumerate(r["prefill"]):
            if cfg.moe is not None and [c["fn"] for c in pre["moe"]] != ["moe_a2a"] * cfg.num_layers:
                raise AssertionError(f"{who} prefill {i}: MoE calls {pre['moe']}")
            if cuda and pre["launches"]["flash_attention"] != n_attn:
                raise AssertionError(f"{who} prefill {i}: K1 launched "
                                     f"{pre['launches']}, not once an attention layer")
            apart = _rel(pre["logits"], ranks[0]["prefill"][i]["logits"])
            if apart > 1e-6:
                raise AssertionError(f"{who}'s prefill logits are {apart} from rank 0's")
            launches.update(pre["launches"])
        for t, step in enumerate(r["decode"]["logits"]):
            apart = _rel(step, ranks[0]["decode"]["logits"][t])
            if apart > 1e-6:
                raise AssertionError(f"{who}'s decode {t} logits are {apart} from rank 0's")
        if cuda and r["decode"]["launches"]["paged_attention"] != n_attn * args.decodes:
            raise AssertionError(f"{who} decodes: K2 launched {r['decode']['launches']}")
        launches.update(r["decode"]["launches"])
    first = ranks[0]["prefill"][0]
    if any(c["dropped"] for c in first["moe"]):
        raise AssertionError(f"pairs dropped at capacity_factor {first['cf']}: {first['moe']}")
    pairs = [("prefill", first["logits"], ref["prefill"][0]["logits"])] + [
        (f"decode {t}", got, exp) for t, (got, exp) in
        enumerate(zip(ranks[0]["decode"]["logits"], ref["decode"]["logits"]))]
    for what, got, exp in pairs:
        if tuple(got.shape) != (args.batch, cfg.vocab_size) or not torch.isfinite(got).all():
            raise AssertionError(f"{what}: logits {tuple(got.shape)} not finite or misshapen")
        rel = _rel(got, exp)
        if rel > tol:
            raise AssertionError(f"{what}: the ranks' and the one-process model's logits "
                                 f"differ by {rel} (> {tol})")
    return launches


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.rank >= 0:
        run_rank(args)
        return
    ranks = launch(args)
    ref = reference(args)
    for line in summary(ranks, ref):
        print(line)
    check(args, ranks, ref, 5e-2 if args.dtype == "bfloat16" else 2e-4)


if __name__ == "__main__":
    main()
