"""Expert-parallel serving of an MoE model: ``moe_impl="a2a"`` over ranks.

    PYTHONPATH=src python -m repro_torch.launch.expert_parallel \\
        --arch qwen3_30b_a3b --layers 8 --ranks 2 --batch 4 --prompt 512

It starts ``--ranks`` processes of itself, which meet in a gloo group
through a ``FileStore`` in a temporary directory, on a ("data", "model")
mesh of (1, ranks).  Each rank builds the whole model from seed 0 (the same
weights on every rank), keeps its experts (``launch.mesh.shard_params``)
and, under the ambient mesh, prefills ``--batch`` prompts of ``--prompt``
random tokens (numpy seed 0) into a fresh cache once for each capacity
factor (:func:`capacity_factors`), then takes one decode step after the
first prefill.  A prefill runs ``layers.moe_a2a`` in
every MoE layer (the all-to-all path: the ranks split the sequence), the
decode its dropless fallback (one token does not split).  Each rank saves
its logits, the pairs dropped, each MoE layer's milliseconds and its kernel
launch counts.  The launcher then runs :func:`dropless`, prints
:func:`summary` and applies :func:`check`; it exits non-zero if a rank
fails or a check does.

On one card every rank runs on it (``cuda`` is device ``rank % count``):
NCCL refuses two ranks on one device, and gloo moves the exchanges' bytes
through host memory while attention and the expert products stay on the
card.  Times taken so are of ranks sharing one card, not of several cards.

:func:`dropless` runs the same prompts through the one-process dropless model
on the same weights, the reference the ranks are held against.

CPU rehearsal (the reduced config, 4 ranks of one expert each)::

    PYTHONPATH=src python -m repro_torch.launch.expert_parallel --reduced \\
        --device cpu --dtype float32 --ranks 4 --batch 2 --prompt 16
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

SEED = 0            # the weights' generator and the prompts' numpy seed
TIMEOUT = 600.0     # seconds for all ranks to finish


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3_30b_a3b")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this (0: all)")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def model_config(args: argparse.Namespace, moe_impl: str = "a2a", capacity_factor=None):
    from repro_torch.configs import get_config, get_reduced_config
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    if cfg.moe is None:
        raise ValueError(f"{args.arch} has no MoE")
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers, layer_pattern=None)
    moe = cfg.moe if capacity_factor is None else dataclasses.replace(
        cfg.moe, capacity_factor=float(capacity_factor))
    return cfg.replace(moe_impl=moe_impl, moe=moe)


def capacity_factors(args: argparse.Namespace) -> List[float]:
    """The ranks' count, at which a destination has room for all of a rank's
    pairs (cap = n_loc·K: nothing drops), and the config's own."""
    return [float(args.ranks), model_config(args).moe.capacity_factor]


def prompts(args: argparse.Namespace, vocab: int, device):
    import torch
    rng = np.random.default_rng(SEED)
    toks = rng.integers(1, vocab, size=(args.batch, args.prompt), dtype=np.int64)
    return torch.from_numpy(toks).to(device)


@contextlib.contextmanager
def moe_timing(device):
    """Record each MoE block's milliseconds (host clock around the call,
    the device synchronised before and after) and its ``dropped`` count
    while the block runs: ``layers.moe`` and ``layers.moe_a2a``, which the
    model looks up at each call, are wrapped and restored after."""
    import torch

    from repro_torch.models import layers as L
    calls: List[Dict] = []
    depth = [0]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def wrap(fn):
        def timed(cfg, p, x, **kw):
            if depth[0]:                    # a fallback inside a timed call
                return fn(cfg, p, x, **kw)
            depth[0] += 1
            sync()
            t0 = time.perf_counter()
            try:
                y, aux = fn(cfg, p, x, **kw)
                sync()
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


def _serve(args, cfg_of, params, device, dtype) -> Dict:
    """Prefill the prompts once untimed, then once for each capacity factor
    into a fresh cache (the model of ``cfg_of(cf)``), and decode one token
    after the first.
    Returns {"prefill": [{"cf", "logits", "moe", "launches", "seconds"}],
    "decode": {...}}."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import build_model
    out: Dict = {"prefill": []}
    cf_list = capacity_factors(args)
    tokens = prompts(args, cfg_of(cf_list[0]).vocab_size, device)
    cache_len = -(-(args.prompt + 16) // 16) * 16
    with torch.no_grad():                    # a warm-up, so that no timed call is a first one
        model = build_model(cfg_of(cf_list[0]))
        model.prefill(params, {"tokens": tokens},
                      model.init_cache(args.batch, cache_len, dtype, device))
    for i, cf in enumerate(cf_list):
        model = build_model(cfg_of(cf))
        cache = model.init_cache(args.batch, cache_len, dtype, device)
        ops.reset_launch_counts()
        with torch.no_grad(), moe_timing(device) as calls:
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": tokens}, cache)
            logits = logits.float().cpu()
            secs = time.perf_counter() - t0
        out["prefill"].append({"cf": cf, "logits": logits, "moe": calls,
                               "launches": ops.launch_counts(), "seconds": secs})
        if i == 0:
            ops.reset_launch_counts()
            with torch.no_grad(), moe_timing(device) as calls:
                step, _ = model.decode_step(params, cache, tokens[:, -1:])
                step = step.float().cpu()
            out["decode"] = {"logits": step, "moe": calls, "launches": ops.launch_counts()}
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


def dropless(args: argparse.Namespace) -> Dict:
    """The prompts through the one-process dropless model (``moe_impl=
    "ragged"``) on the weights every rank builds: what :func:`launch`'s
    ranks are held against."""
    import torch

    from repro_torch.models.transformer import build_model
    device = _device(args)
    dtype = getattr(torch, args.dtype)
    cfg = model_config(args, "ragged")
    params = build_model(cfg).init(torch.Generator(device).manual_seed(SEED), dtype)
    return _serve(args, lambda cf: model_config(args, "ragged", cf), params, device, dtype)


def run_rank(args: argparse.Namespace) -> None:
    """One rank: join the group, build and shard the model, serve, save."""
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
        cfg = model_config(args)
        with mesh.use_mesh(dm):
            t0 = time.perf_counter()
            params = mesh.shard_params(build_model(cfg).init(
                torch.Generator(device).manual_seed(SEED), dtype))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
            built = time.perf_counter() - t0
            res = _serve(args, lambda cf: model_config(args, "a2a", cf), params, device, dtype)
        res.update(rank=args.rank, build_seconds=built,
                   experts=params["blocks"]["moe"]["w_in"].shape[1],
                   memory=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        torch.save(res, Path(args.out) / f"rank{args.rank}.pt")
    finally:
        dist.destroy_process_group()


def launch(args: argparse.Namespace) -> List[Dict]:
    """Start ``args.ranks`` rank processes, wait for all of them, and return
    each rank's results; raises if one fails (the others are stopped)."""
    import torch
    with tempfile.TemporaryDirectory(prefix="ep-") as tmp:
        out = Path(tmp)
        env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")       # every rank is on this host
        src = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        base = [sys.executable, "-m", "repro_torch.launch.expert_parallel",
                "--arch", args.arch, "--layers", str(args.layers), "--ranks", str(args.ranks),
                "--batch", str(args.batch), "--prompt", str(args.prompt),
                "--device", args.device, "--dtype", args.dtype, "--out", str(out),
                "--store", str(out / "store")] + (["--reduced"] if args.reduced else [])
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
            raise RuntimeError("expert-parallel ranks failed:\n" + "\n".join(failed))
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(args.ranks)]


def summary(ranks: List[Dict], ref: Dict) -> List[str]:
    """One line per prefill and decode: the pairs dropped, the MoE layers'
    milliseconds on each rank and the dropless model's, the logits' largest
    distance from the dropless model's, relative to its largest."""
    def rel(got, exp):
        return float((got - exp).abs().max() / exp.abs().max())

    lines = []
    for i, pre in enumerate(ranks[0]["prefill"]):
        moe_ms = [round(sum(c["ms"] for c in r["prefill"][i]["moe"]), 3) for r in ranks]
        dropped = sum(c["dropped"] or 0 for c in pre["moe"])
        ref_pre = ref["prefill"][i]
        lines.append(f"prefill at capacity_factor {pre['cf']}: {dropped} (token, choice) pairs "
                     f"dropped over {len(pre['moe'])} MoE layers; MoE ms by rank {moe_ms}, "
                     f"dropless {sum(c['ms'] for c in ref_pre['moe']):.3f}; logits "
                     f"{rel(pre['logits'], ref_pre['logits']):.3e} from the dropless model's")
    moe_ms = [round(sum(c["ms"] for c in r["decode"]["moe"]), 3) for r in ranks]
    lines.append(f"decode: MoE ms by rank {moe_ms}; logits "
                 f"{rel(ranks[0]['decode']['logits'], ref['decode']['logits']):.3e} "
                 "from the dropless model's")
    return lines


def check(args: argparse.Namespace, ranks: List[Dict], ref: Dict, tol: float) -> collections.Counter:
    """Raise unless the ranks served as they should: each holds its E / ranks
    experts; every prefill ran ``moe_a2a`` in every layer and, on the card,
    K1 once a layer, and every decode K2 once a layer; the ranks' logits
    agree (1e-6 of the largest); nothing dropped at the first capacity
    factor; and there the prefill's logits, and the decode's, lie within
    ``tol`` of the dropless model's, relative to its largest, finite and of
    shape (batch, vocab).  Returns the ranks' kernel launches, summed."""
    import torch
    cfg = model_config(args)
    layers = cfg.num_layers
    cuda = args.device != "cpu"
    launches: collections.Counter = collections.Counter()
    for r in ranks:
        if r["experts"] != cfg.moe.num_experts // args.ranks:
            raise AssertionError(f"rank {r['rank']} holds {r['experts']} experts")
        for i, pre in enumerate(r["prefill"]):
            if [c["fn"] for c in pre["moe"]] != ["moe_a2a"] * layers:
                raise AssertionError(f"rank {r['rank']} prefill {i}: MoE calls {pre['moe']}")
            if cuda and pre["launches"]["flash_attention"] != layers:
                raise AssertionError(f"rank {r['rank']} prefill {i}: K1 launched "
                                     f"{pre['launches']}, not once a layer")
            other = ranks[0]["prefill"][i]["logits"]
            apart = float((pre["logits"] - other).abs().max() / other.abs().max())
            if apart > 1e-6:
                raise AssertionError(f"rank {r['rank']}'s logits are {apart} from rank 0's")
            launches.update(pre["launches"])
        if cuda and r["decode"]["launches"]["paged_attention"] != layers:
            raise AssertionError(f"rank {r['rank']} decode: K2 launched {r['decode']['launches']}")
        launches.update(r["decode"]["launches"])
    first = ranks[0]["prefill"][0]
    if any(c["dropped"] for c in first["moe"]):
        raise AssertionError(f"pairs dropped at capacity_factor {first['cf']}: {first['moe']}")
    for what, got, exp in (("prefill", first["logits"], ref["prefill"][0]["logits"]),
                           ("decode", ranks[0]["decode"]["logits"], ref["decode"]["logits"])):
        if tuple(got.shape) != (args.batch, cfg.vocab_size) or not torch.isfinite(got).all():
            raise AssertionError(f"{what}: logits {tuple(got.shape)} not finite or misshapen")
        rel = float((got - exp).abs().max() / exp.abs().max())
        if rel > tol:
            raise AssertionError(f"{what}: a2a and dropless logits differ by {rel} (> {tol})")
    return launches


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.rank >= 0:
        run_rank(args)
        return
    ranks = launch(args)
    ref = dropless(args)
    for line in summary(ranks, ref):
        print(line)
    check(args, ranks, ref, 5e-2 if args.dtype == "bfloat16" else 2e-4)


if __name__ == "__main__":
    main()
