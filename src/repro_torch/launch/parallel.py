"""Serving over "model" ranks: tensor parallelism, and expert parallelism for an MoE;
and on a ("data", "model") or ("pod", "data", "model") mesh, as the reference's decode
cells place it.

    PYTHONPATH=src python -m repro_torch.launch.parallel \\
        --arch llama3_70b --layers 16 --ranks 4 --batch 4 --prompt 256 --decodes 4
    PYTHONPATH=src python -m repro_torch.launch.parallel \\
        --arch qwen3_30b_a3b --layers 8 --ranks 2 --batch 4 --prompt 512
    PYTHONPATH=src python -m repro_torch.launch.parallel \\
        --arch whisper_base --ranks 2 --batch 4 --prompt 64 --frames 1500 --decodes 4
    PYTHONPATH=src python -m repro_torch.launch.parallel \\
        --arch mamba2_370m --ranks 4 --batch 2 --prompt 1000 --decodes 4
    PYTHONPATH=src python -m repro_torch.launch.parallel \\
        --arch mixtral_8x7b --layers 8 --mesh 2,2 --batch 1 --prompt 6144 --decodes 8
    PYTHONPATH=src python -m repro_torch.launch.parallel --arch qwen2_5_3b \\
        --layers 12 --mesh 1,4 --batch 8 --prompt 512 --decodes 4 --opt kv_seq_shard

It starts ``--ranks`` processes of itself, which meet in a gloo group
through a ``FileStore`` in a temporary directory, on a ("data", "model")
mesh of (1, ranks).  Each rank builds only its blocks of the model from
seed 0 (``launch.mesh.build_params``: each leaf that the serve rules place
on "model" — the attention's heads, or head_dim where the heads do not
split, the MLP's F, the RG-LRU's width, the SSD's packed ``w_in`` columns
and ``w_out`` rows, the embeddings' vocabulary, the MoE's experts or,
where they do not divide, their FFN width — drawn whole as the one-process
model draws it and cut to the rank's block at once) and the cache of its
blocks (``init_cache(..., params=)``: KV heads or head_dim, the RG-LRU
states' width, the SSD state's heads and conv channels), then prefills
``--batch`` prompts of ``--prompt`` random tokens (numpy seed 0) into the
fresh cache, after ``--frames`` random frame embeddings a row for an
encoder-decoder (numpy seed 0, a generator of their own), and decodes
``--decodes`` more tokens (drawn after the prompts) through
``decode_slots``.  The layers run Megatron's split (``models.layers``): a
rank's query heads (every one where they do not split) over their KV
heads, gathered to whole heads where the cache holds a block of head_dim,
K1 and K2 on those heads; the RG-LRU on its block of the width, its
conv'd input gathered; the SSD on its heads (K3 over them), the columns
its heads need exchanged out of the packed projection and out of the
conv's blocks; experts on their FFN width with the gate and up columns of
a rank's rows exchanged; the partial outputs reduced over "model" in fp32;
the vocabulary's logits gathered.  An MoE model also runs
``moe_impl="a2a"`` and, where its experts divide over the ranks, prefills
once more into a fresh cache for each capacity factor
(:func:`capacity_factors`): a prefill runs ``layers.moe_a2a`` in every MoE
layer (the all-to-all: the ranks split the sequence), a decode its
dropless fallback on the sharded experts.

``--mesh D,M`` (or ``P,D,M``) serves on a ("data", "model") mesh of (D, M)
(or ("pod", "data", "model") of (P, D, M)) instead of ``--ranks``, which
means (1, ranks): each rank holds the serve rules' blocks at the mesh
(``launch.mesh.shard_params``: also the MoE experts' d over the batch axes,
gathered where the MoE runs) and its blocks of the cache
(``init_cache(..., params=)`` under the mesh).  Where the batch axes divide
``--batch``, a rank is given its rows (``launch.mesh.batch_rows``, pod-major)
and serves them as one process does; else every rank is given every row and
holds its block of each attention layer's KV slots over "data": K2 runs on
each run of its block that a query sees and the ranks' attention is merged
over "data" (``models.transformer.block_runs``, ``layers.merge_blocks``).
An MoE serves dropless (``moe_impl="ragged"``) on such a mesh, as the
one-process model does.

``--opt`` takes the reference's decode knobs (``launch.specs.OPTS``), each
set as its ``build_cell`` sets it: ``kv_seq_shard`` cuts the KV sequence
(and an encoder-decoder's frames) over "model" where the batch axes divide
``--batch`` (the cache rules with ``seq_shard``; every KV head whole on
each rank, a decode's attention merged over "model"), ``kv_defer_append``
defers the KV append (also under context parallelism), ``moe_a2a`` runs the
expert-parallel MoE on batch axes too, ``scores_bf16`` sets
``attn_scores_dtype``, which the port's kernels do not read.  The cache
length is rounded to whole pages of K2 on every rank that holds a block of
it (:func:`cache_len`).

Each rank saves its logits at every step, the milliseconds of its prefills
and decodes (the host's clock, the device synchronised) and of each
decode's K2 calls, gathers, all-reduces and exchanges (:func:`timing`), the bytes it
received through the gathers and exchanges of the layers in each
(``layers.GATHERED``), every collective it issued in each
(``layers.collective_census``, what ``launch.rank_cost`` holds the ranks
to) and how many experts each gather of the experts' d took
(``layers.EXPERTS_KEPT``), each MoE layer's milliseconds and dropped pairs, its
kernel launch counts, its leaves' and cache's shapes and, on the card, the
bytes its parameters and its cache hold (``torch.cuda.memory_allocated()``
grown by building each).  The
launcher then runs :func:`reference`, prints :func:`summary` and applies
:func:`check`; it exits non-zero if a rank fails or a check does.

On one card every rank runs on it (``cuda`` is device ``rank % count``):
NCCL refuses two ranks on one device, and gloo moves the collectives'
bytes through host memory while the layers stay on the card.  Times taken
so are of ranks sharing one card, not of several cards.  Ranks that share
a card build their blocks one after another, so that only one whole leaf
is drawn on it at a time.

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
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.launch import ranks as rank_procs
from repro_torch.launch.ranks import allocated as _allocated, sync as _sync

SEED = 0            # the weights' generator and the tokens' numpy seed
ALLOC_BLOCK = 512   # the CUDA caching allocator rounds each tensor up to this
ALLOC_UNSPLIT = 1 << 20   # and leaves up to this much of a larger block unsplit with it


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3_30b_a3b")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this (0: all)")
    ap.add_argument("--config", action="append", default=[], metavar="FIELD=INT",
                    help="set an integer field of the config (repeatable)")
    ap.add_argument("--ranks", type=int, default=2,
                    help="'model' ranks of a (1, ranks) mesh, unless --mesh is given")
    ap.add_argument("--mesh", default="", metavar="D,M|P,D,M",
                    help="serve on a ('data', 'model') or ('pod', 'data', 'model') mesh")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--decodes", type=int, default=1)
    ap.add_argument("--frames", type=int, default=0,
                    help="frame embeddings a row for an encoder-decoder (0: none)")
    ap.add_argument("--opt", action="append", default=[], choices=_opts(),
                    help="one of the reference's decode knobs (repeatable)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bfloat16")
    rank_procs.add_rank_args(ap)
    args = ap.parse_args(argv)
    if args.mesh:
        args.ranks = int(np.prod(list(mesh_axes(args).sizes.values())))
    return args


def _opts():
    from repro_torch.launch.specs import OPTS
    return OPTS


def mesh_axes(args: argparse.Namespace):
    """The ``launch.mesh.MeshAxes`` the ranks serve on: ``--mesh``, or
    ("data", "model") of (1, ``--ranks``)."""
    from repro_torch.launch.mesh import MeshAxes
    if not args.mesh:
        return MeshAxes(("data", "model"), (1, args.ranks))
    sizes = [int(n) for n in args.mesh.split(",")]
    if len(sizes) not in (2, 3):
        raise ValueError(f"--mesh takes D,M or P,D,M, not {args.mesh!r}")
    return MeshAxes(("pod", "data", "model")[-len(sizes):], sizes)


def moe_impl(args: argparse.Namespace) -> str:
    """The ranks' MoE: expert-parallel (``a2a``) on "model" ranks alone or
    under ``--opt moe_a2a``, dropless where there are batch axes, as the
    one-process model runs it and the reference's decode cells place it."""
    return "a2a" if mesh_axes(args).batch_size() == 1 or "moe_a2a" in args.opt else "ragged"


def model_config(args: argparse.Namespace, moe_impl: str = "a2a", capacity_factor=None):
    """The served config: ``--arch`` (reduced), cut to ``--layers``, with
    the ``--config`` fields set and the ``--opt`` knobs as the reference's
    ``build_cell`` sets them (``scores_bf16``: ``attn_scores_dtype``, which
    the port's attention does not read; ``kv_defer_append``:
    ``kv_append="defer"``; ``moe_a2a`` through ``moe_impl``; ``kv_seq_shard``
    is the cache's placement, :func:`seq_shard`); an MoE's with ``moe_impl``
    and, where given, ``capacity_factor``."""
    from repro_torch.configs import get_config, get_reduced_config
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers, layer_pattern=None)
    if args.config:
        cfg = cfg.replace(**{k: int(v) for k, v in (kv.split("=", 1) for kv in args.config)})
    if "scores_bf16" in args.opt:
        cfg = cfg.replace(attn_scores_dtype="bfloat16")
    if "kv_defer_append" in args.opt:
        cfg = cfg.replace(kv_append="defer")
    if cfg.moe is None:
        return cfg
    moe = cfg.moe if capacity_factor is None else dataclasses.replace(
        cfg.moe, capacity_factor=float(capacity_factor))
    return cfg.replace(moe_impl=moe_impl, moe=moe)


def capacity_factors(args: argparse.Namespace) -> List[Optional[float]]:
    """An expert-parallel MoE's: the ranks' count, at which a destination
    has room for all of a rank's pairs (cap = n_loc·K: nothing drops), and
    the config's own; the one prefill of a dense model, or of an MoE whose
    experts do not divide over the ranks (dropless on their FFN width), has
    none."""
    cfg = model_config(args)
    if cfg.moe is None or cfg.moe.num_experts % args.ranks or moe_impl(args) != "a2a":
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


def frames(args: argparse.Namespace, d_model: int, device, dtype):
    """The frame embeddings (batch, frames, d_model) of an encoder-decoder,
    standard normal from a numpy generator of seed 0 of their own; None
    without ``--frames``."""
    import torch
    if not args.frames:
        return None
    fe = np.random.default_rng(SEED).standard_normal((args.batch, args.frames, d_model))
    return torch.from_numpy(fe.astype(np.float32)).to(device=device, dtype=dtype)


def seq_shard(args: argparse.Namespace) -> bool:
    """``--opt kv_seq_shard``: the cache rules' KV sequence over "model"."""
    return "kv_seq_shard" in args.opt


def cache_len(args: argparse.Namespace) -> int:
    """The prompt and the decodes, rounded up to whole pages of K2 on every
    rank that may hold a block of the sequence: D blocks over "data" where
    the batch axes do not divide ``--batch``, M over "model" under
    ``kv_seq_shard`` where they do."""
    axes = mesh_axes(args)
    n = (axes.sizes["data"] if args.batch % axes.batch_size()
         else axes.model_size() if seq_shard(args) else 1)
    return -(-(args.prompt + args.decodes) // (16 * n)) * 16 * n


def _init_cache(args, model, dtype, device, params):
    extra = {"enc_frames": args.frames} if args.frames else {}
    return model.init_cache(args.batch, cache_len(args), dtype, device, params=params,
                            seq_shard=seq_shard(args), **extra)


MOE_FNS = ("moe", "moe_a2a")
# what a decode step's time is split into: K2, and the collectives over
# "model" that the model's own layers call; on a mesh with batch axes also
# the experts' gather over them (inside the MoE, timed apart) and the merge
# of the "data" ranks' attention over their blocks of the KV sequence
PARTS = {"paged_attention": "K2", "_all_gather": "gathers", "_all_reduce": "reduces",
         "_exchange": "exchanges", "gather_experts": "experts", "merge_blocks": "merges"}
INNER = ("gather_experts",)     # timed even inside a timed call


@contextlib.contextmanager
def timing(device):
    """Record the milliseconds of each call (host clock around it, the
    device synchronised before and after) to ``layers.moe``,
    ``layers.moe_a2a`` (with its ``dropped`` count), ``ops.paged_attention``
    (K2), the gathers, all-reduces and all-to-all exchanges over "model"
    (``layers._all_gather``, ``layers._all_reduce``, ``layers._exchange``),
    the experts' gather over the batch axes (``layers.gather_experts``) and
    the merge over "data" (``layers.merge_blocks``) while the model runs:
    the model looks each up at each call, so each is wrapped and restored
    after.  A call inside a timed call (an MoE block's collectives) is not
    timed apart, except the experts' gather (``INNER``)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    targets = [(L, name) for name in MOE_FNS + ("_all_gather", "_all_reduce", "_exchange",
                                                "gather_experts", "merge_blocks")]
    targets.append((ops, "paged_attention"))
    calls: List[Dict] = []
    depth = [0]

    def wrap(name, fn):
        def timed(*a, **kw):
            if depth[0] and name not in INNER:
                return fn(*a, **kw)
            depth[0] += 1
            _sync(device)
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                _sync(device)
            finally:
                depth[0] -= 1
            aux = out[1] if name in MOE_FNS else {}
            calls.append({"fn": name, "ms": (time.perf_counter() - t0) * 1e3,
                          "dropped": int(aux["dropped"]) if "dropped" in aux else None})
            return out
        return timed

    originals = [getattr(mod, name) for mod, name in targets]
    for (mod, name), fn in zip(targets, originals):
        setattr(mod, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(targets, originals):
            setattr(mod, name, fn)


def _moe_calls(calls: List[Dict]) -> List[Dict]:
    return [c for c in calls if c["fn"] in MOE_FNS]


def _parts_ms(calls: List[Dict]) -> Dict[str, float]:
    """{"K2", "gathers", "reduces", "exchanges", "experts", "merges":
    milliseconds summed over ``calls``}."""
    out = dict.fromkeys(PARTS.values(), 0.0)
    for c in calls:
        if c["fn"] in PARTS:
            out[PARTS[c["fn"]]] += c["ms"]
    return out


def _shapes(tree) -> Dict[str, tuple]:
    from repro_torch.launch.mesh import leaves_with_names
    return {name: tuple(leaf.shape) for name, leaf in leaves_with_names(tree)}


def _reset_records() -> None:
    from repro_torch.models import layers
    layers.GATHERED.clear()
    layers.COLLECTIVES.clear()
    layers.EXPERTS_KEPT.clear()


def _records() -> Dict:
    """What the model's layers recorded since :func:`_reset_records`:
    {"gathered": ``layers.GATHERED``, "census": the collectives issued
    (``layers.collective_census``), "kept": how many experts each gather
    of the experts' d took (``layers.EXPERTS_KEPT``)}."""
    from repro_torch.models import layers
    return {"gathered": dict(layers.GATHERED), "census": layers.collective_census(),
            "kept": list(layers.EXPERTS_KEPT)}


def _serve(args, cfg_of, params, device, dtype, rows: slice, warm: bool = True) -> Dict:
    """Prefill and decode once untimed (where ``warm``), then prefill the
    prompts' ``rows`` once for each capacity factor into a fresh cache (the
    model of ``cfg_of(cf)``), and decode ``--decodes`` tokens of those rows
    through ``decode_slots`` after the first.  Returns {"prefill": [{"cf", "logits", "moe",
    "launches", "ms", "gathered", "census", "kept"}], "decode": {"logits": [...],
    "ms": [...], "gathered": [...], "census": [...], "kept": [...], "parts": [...], "moe",
    "launches"}, "cache": the first cache's leaf shapes, "cache_bytes"}; "gathered",
    "census" and "kept" are the prefill's or each decode's :func:`_records`,
    "parts" each decode's :func:`_parts_ms`."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models.transformer import build_model
    out: Dict = {"prefill": []}
    cf_list = capacity_factors(args)
    cfg = cfg_of(cf_list[0])
    prompt, fed = tokens(args, cfg.vocab_size, device)
    prompt, fed = prompt[rows], fed[:, rows]
    fe = frames(args, cfg.d_model, device, dtype)
    inputs = {"tokens": prompt} if fe is None else {"tokens": prompt,
                                                    "frontend_embeds": fe[rows]}
    rows = torch.arange(prompt.shape[0], device=device)
    if warm:                                 # so that no timed call is a first one
        with torch.no_grad():
            model = build_model(cfg)
            cache = _init_cache(args, model, dtype, device, params)
            model.prefill(params, inputs, cache)
            model.decode_slots(params, cache, fed[0], rows)
            del cache
    for i, cf in enumerate(cf_list):
        model = build_model(cfg_of(cf))
        before = _allocated(device)
        cache = _init_cache(args, model, dtype, device, params)
        if i == 0:
            out.update(cache=_shapes(cache), cache_bytes=_allocated(device) - before)
        ops.reset_launch_counts()
        _reset_records()
        with torch.no_grad(), timing(device) as calls:
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, inputs, cache)
            _sync(device)
            ms = (time.perf_counter() - t0) * 1e3
        out["prefill"].append({"cf": cf, "logits": logits.float().cpu(),
                               "moe": _moe_calls(calls), "launches": ops.launch_counts(),
                               "ms": ms, **_records()})
        if i == 0:
            steps, step_ms, parts, records = [], [], [], []
            ops.reset_launch_counts()
            with torch.no_grad(), timing(device) as calls:
                for t in range(args.decodes):
                    _reset_records()
                    first = len(calls)
                    t0 = time.perf_counter()
                    step = model.decode_slots(params, cache, fed[t], rows)
                    _sync(device)
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    steps.append(step.float().cpu())
                    records.append(_records())
                    parts.append(_parts_ms(calls[first:]))
            out["decode"] = {"logits": steps, "ms": step_ms, "moe": _moe_calls(calls),
                             "launches": ops.launch_counts(), "parts": parts,
                             **{k: [r[k] for r in records] for k in ("gathered", "census",
                                                                     "kept")}}
        del cache
    return out


def reference(args: argparse.Namespace) -> Dict:
    """The tokens through the one-process model (an MoE's dropless,
    ``moe_impl="ragged"``) on the weights every rank builds its blocks of:
    what :func:`launch`'s ranks are held against."""
    import torch

    from repro_torch.models.transformer import build_model
    device = rank_procs.rank_device(args.device)
    dtype = getattr(torch, args.dtype)
    cfg = model_config(args, "ragged")
    params = build_model(cfg).init(torch.Generator(device).manual_seed(SEED), dtype)
    return _serve(args, lambda cf: model_config(args, "ragged", cf), params, device, dtype,
                  slice(0, args.batch))


def run_rank(args: argparse.Namespace) -> None:
    """One rank: join the group, build its blocks of the model, serve, save."""
    import torch

    from repro_torch.launch import mesh
    from repro_torch.models.transformer import build_model
    with rank_procs.joined(args, args.ranks):
        device = rank_procs.rank_device(args.device, args.rank)
        dtype = getattr(torch, args.dtype)
        axes = mesh_axes(args)
        dm = mesh.device_mesh(axes, device.type)
        with mesh.use_mesh(dm):
            model = build_model(model_config(args))
            model.init(torch.Generator().manual_seed(SEED), dtype, device="meta")
            # raises for a placement no layer runs (model_placements)
            params, param_bytes, built = rank_procs.build_in_turns(
                device, args.rank, args.ranks,
                lambda: rank_procs.rank_params(model, device, dtype, SEED))
            rows = mesh.batch_rows(args.batch)
            built_peak = _peak(device)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            # on batch axes every pass gathers the experts' d through host
            # memory, which a warm-up would repeat for nothing its times need
            res = _serve(args, lambda cf: model_config(args, moe_impl(args), cf), params, device,
                         dtype, rows, warm=axes.batch_size() == 1)
        res.update(coords={a: dm[a].get_local_rank() for a in axes.names},
                   rows=(rows.start, rows.stop))
        if device.type == "cuda":       # (allocated, reserved) at most while serving
            res.update(serve_memory=(_peak(device), torch.cuda.max_memory_reserved(device)))
        res.update(rank=args.rank, build_seconds=built, params=_shapes(params),
                   param_bytes=param_bytes, memory=max(built_peak, _peak(device)))
        rank_procs.save(args, res)


def _peak(device) -> int:
    """``torch.cuda.max_memory_allocated``; 0 on the CPU."""
    import torch
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def launch(args: argparse.Namespace) -> List[Dict]:
    """Start ``args.ranks`` rank processes, wait for all of them, and return
    each rank's results; raises if one fails (the others are stopped)."""
    argv = ["--arch", args.arch, "--layers", str(args.layers), "--ranks", str(args.ranks),
            "--mesh", args.mesh,
            "--batch", str(args.batch), "--prompt", str(args.prompt),
            "--decodes", str(args.decodes), "--frames", str(args.frames),
            "--device", args.device, "--dtype", args.dtype]
    argv += [a for opt in args.opt for a in ("--opt", opt)]
    argv += (["--reduced"] if args.reduced else []) + [
        a for kv in args.config for a in ("--config", kv)]
    return rank_procs.launch("repro_torch.launch.parallel", argv, args.ranks)


def _rel(got, exp) -> float:
    return float((got - exp).abs().max() / exp.abs().max())


def _worst(ranks: List[Dict], ref_logits, got_of) -> float:
    """The largest relative distance of any rank's logits (``got_of(rank)``,
    its rows) from the one-process model's rows."""
    return max(_rel(got_of(r), ref_logits[slice(*r["rows"])]) for r in ranks)


def summary(ranks: List[Dict], ref: Dict) -> List[str]:
    """One line per prefill and one for the decodes: each rank's
    milliseconds and the one-process model's, an MoE's dropped pairs and
    MoE layers' milliseconds, and the logits' largest distance, over the
    ranks, from the one-process model's rows, relative to its largest."""
    lines = []
    for i, pre in enumerate(ranks[0]["prefill"]):
        ref_pre = ref["prefill"][i]
        worst = _worst(ranks, ref_pre["logits"], lambda r: r["prefill"][i]["logits"])
        line = (f"prefill{'' if pre['cf'] is None else ' at capacity_factor ' + str(pre['cf'])}: "
                f"ms by rank {[round(r['prefill'][i]['ms'], 3) for r in ranks]}, one process "
                f"{ref_pre['ms']:.3f}; logits {worst:.3e} from the one-process model's")
        if pre["moe"]:
            dropped = sum(c["dropped"] or 0 for c in pre["moe"])
            moe_ms = [round(sum(c["ms"] for c in r["prefill"][i]["moe"]), 3) for r in ranks]
            line += (f"; {dropped} (token, choice) pairs dropped over {len(pre['moe'])} MoE "
                     f"layers; MoE ms by rank {moe_ms}, dropless "
                     f"{sum(c['ms'] for c in ref_pre['moe']):.3f}")
        if pre["gathered"]:
            line += f"; gathered by each rank {pre['gathered']} bytes"
        lines.append(line)
    dec, ref_dec = ranks[0]["decode"], ref["decode"]
    worst = max((_worst(ranks, e, lambda r, t=t: r["decode"]["logits"][t])
                 for t, e in enumerate(ref_dec["logits"])), default=0.0)
    line = (f"{len(dec['ms'])} decodes: ms by rank "
            f"{[[round(ms, 3) for ms in r['decode']['ms']] for r in ranks]}, one process "
            f"{[round(ms, 3) for ms in ref_dec['ms']]}; logits at most {worst:.3e} from the "
            "one-process model's")
    if any(dec["gathered"]):
        line += f"; gathered by each rank a step {dec['gathered']} bytes"
    for what, key, part in (("the experts' d gathered over the batch axes", "experts", "experts"),
                            ("the blocks' attention merged over 'data'", "merge", "merges"),
                            ("kv_seq_shard's exchange over 'model' (query heads and the token's "
                             "KV heads gathered, the blocks' attention merged)", "seq_shard",
                             "merges")):
        if any(step.get(key) for step in dec["gathered"]):
            line += (f"; {what}: {[step.get(key, 0) for step in dec['gathered']]} bytes by "
                     "decode, ms by rank "
                     f"{[[round(p[part], 3) for p in r['decode']['parts']] for r in ranks]}")
    line += ("; of each step, ms in " + "/".join(PARTS.values()) + " by rank "
             f"{[[[round(ms, 3) for ms in p.values()] for p in r['decode']['parts']] for r in ranks]}")
    if dec["moe"]:
        line += (f"; MoE ms by rank "
                 f"{[round(sum(c['ms'] for c in r['decode']['moe']), 3) for r in ranks]}")
    lines.append(line)
    return lines


def expected(args: argparse.Namespace):
    """What a rank must hold: ({leaf: shape} of its parameters and of its
    cache, and the bytes of each tensor), from the whole trees on the meta
    device: each leaf the :func:`~repro_torch.launch.mesh.shard_shape` of its
    serve placement at the ranks' mesh (:func:`mesh_axes`; the cache's by
    the cache rules at ``--batch``, :func:`~repro_torch.launch.mesh.cache_shapes`:
    :func:`~repro_torch.launch.mesh.shard_bytes` of the specs, and an
    encoder-decoder's block of the frames padded to whole pages), after
    :func:`~repro_torch.launch.mesh.model_placements` has said that a layer
    runs every placement."""
    import torch

    from repro_torch.launch import mesh
    from repro_torch.models.transformer import build_model
    axes = mesh_axes(args)
    dtype = getattr(torch, args.dtype)
    cfg = model_config(args)
    with mesh.use_mesh(None):
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), dtype, device="meta")
        cache = _init_cache(args, model, dtype, "meta", None)
    mesh.model_placements(params, axes.model_size(), "serve", axes.sizes["data"],
                          axes.sizes.get("pod", 1))
    spec_of = mesh.named_specs(mesh.param_specs(params, axes, "serve"))
    out = []
    for tree, shapes in (
            (params, {name: mesh.shard_shape(tuple(leaf.shape), spec_of[name], axes)
                      for name, leaf in mesh.leaves_with_names(params)}),
            (cache, mesh.cache_shapes(cache, axes, batch=args.batch,
                                      seq_shard=seq_shard(args)))):
        sizes = [int(np.prod(shapes[name])) * leaf.element_size()
                 for name, leaf in mesh.leaves_with_names(tree)]
        out.append((shapes, sizes))
    return out


def kernel_launches(args: argparse.Namespace, coords: Optional[Dict[str, int]] = None):
    """The kernel launches of a rank on the card at mesh coordinates
    ``coords`` ({axis: coordinate}; all 0 by default), ({kernel: count} a
    prefill, [{kernel: count} of each decode]): K1 once a prefill and K2
    once a decode in each attention layer, and for an encoder-decoder also
    each cross attention and, given frames, each encoder layer's K1; K3
    once a prefill in each SSD layer.  Where the rank holds a block of the
    KV sequence (over "data" where the batch axes do not divide
    ``--batch``: every row, at the same position; over "model" under
    ``kv_seq_shard``: its rows), K2 runs once a layer for each run of its
    block that the decode's query sees (``transformer.block_runs``, of the
    cache before the token under ``kv_defer_append``), none for a block the
    query sees nothing of; over a block of the frames, once a cross
    attention over the block's frames."""
    import torch

    from repro_torch.launch import mesh
    from repro_torch.models.transformer import block_runs, build_model
    cfg = model_config(args)
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_pattern)
    n_ssd = sum(kind == "ssd" for kind in cfg.layer_pattern)
    k1 = n_attn if not cfg.is_enc_dec else (
        2 * n_attn + (cfg.encoder.num_layers if args.frames else 0))
    axes = mesh_axes(args)
    with mesh.use_mesh(None):
        whole = _init_cache(args, build_model(cfg), torch.bfloat16, "meta", None)
    blocks = mesh.seq_blocks(whole, axes, coords or {}, batch=args.batch,
                             seq_shard=seq_shard(args))
    k2 = []
    for t in range(args.decodes):
        block = blocks.get("seq_block")
        own = n_attn if block is None else n_attn * len(block_runs(
            [args.prompt + t], block, cfg.sliding_window, cfg.kv_append == "defer"))
        if cfg.is_enc_dec:
            own += n_attn
        k2.append(own)
    return {"flash_attention": k1, "ssd_scan": n_ssd}, [{"paged_attention": n} for n in k2]


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
    every prefill ran, on the card, K1 once an attention layer and K3 once
    an SSD layer, and each decode K2 once an attention layer, or once for
    each run of a rank's block of the KV sequence that the query sees
    (:func:`kernel_launches`: an encoder-decoder's cross attention and
    encoder too); the ranks that serve the same rows agree (1e-6 of the
    largest) at every step; the prefill's logits (an MoE's at the first
    capacity factor, where nothing may drop, and through ``moe_a2a`` in
    every layer on "model" ranks alone) and every decode's lie within
    ``tol`` of the one-process model's rows, relative to its largest,
    finite and of shape (rows, vocab), on every rank.  Returns the ranks'
    kernel launches, summed."""
    import torch
    cfg = model_config(args)
    cuda = args.device != "cpu"
    (p_shapes, p_sizes), (c_shapes, c_sizes) = expected(args)
    launches: collections.Counter = collections.Counter()
    moe_fn = "moe_a2a" if moe_impl(args) == "a2a" else "moe"
    for r in ranks:
        who = f"rank {r['rank']}"
        per_prefill, per_decode = kernel_launches(args, r["coords"])
        same = next(q for q in ranks if q["rows"] == r["rows"])
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
            if cfg.moe is not None and [c["fn"] for c in pre["moe"]] != [moe_fn] * cfg.num_layers:
                raise AssertionError(f"{who} prefill {i}: MoE calls {pre['moe']}")
            if cuda and any(pre["launches"][k] != n for k, n in per_prefill.items()):
                raise AssertionError(f"{who} prefill {i}: launched {pre['launches']}, not "
                                     f"{per_prefill}")
            apart = _rel(pre["logits"], same["prefill"][i]["logits"])
            if apart > 1e-6:
                raise AssertionError(f"{who}'s prefill logits are {apart} from rank "
                                     f"{same['rank']}'s")
            launches.update(pre["launches"])
        for t, step in enumerate(r["decode"]["logits"]):
            apart = _rel(step, same["decode"]["logits"][t])
            if apart > 1e-6:
                raise AssertionError(f"{who}'s decode {t} logits are {apart} from rank "
                                     f"{same['rank']}'s")
        want = collections.Counter()
        for step in per_decode:
            want.update(step)
        if cuda and any(r["decode"]["launches"][k] != n for k, n in want.items()):
            raise AssertionError(f"{who} decodes: launched {r['decode']['launches']}, not "
                                 f"{per_decode} by decode")
        launches.update(r["decode"]["launches"])
        first = r["prefill"][0]
        if any(c["dropped"] for c in first["moe"]):
            raise AssertionError(f"pairs dropped at capacity_factor {first['cf']}: "
                                 f"{first['moe']}")
        rows = slice(*r["rows"])
        pairs = [("prefill", first["logits"], ref["prefill"][0]["logits"][rows])] + [
            (f"decode {t}", got, exp[rows]) for t, (got, exp) in
            enumerate(zip(r["decode"]["logits"], ref["decode"]["logits"]))]
        for what, got, exp in pairs:
            if (tuple(got.shape) != (rows.stop - rows.start, cfg.vocab_size)
                    or not torch.isfinite(got).all()):
                raise AssertionError(f"{who} {what}: logits {tuple(got.shape)} not finite or "
                                     "misshapen")
            rel = _rel(got, exp)
            if rel > tol:
                raise AssertionError(f"{who} {what}: the rank's and the one-process model's "
                                     f"logits differ by {rel} (> {tol})")
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
