"""The port's training entry point: ``repro.launch.train`` in PyTorch.

Trains any registry architecture on synthetic LM data, on the card unless
``--device cpu`` is given: AdamW with a cosine schedule, microbatched
gradient accumulation, remat, and atomic checkpoints with restart (kill it
mid-run and relaunch with the same ``--ckpt-dir``: it resumes from the
newest complete step).  On the card every attention layer runs K1 forward
and K1's gradient kernel backward, and every SSD layer K3 forward and K3's
gradient kernel backward.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \\
        --full-config --steps 8 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --device cpu --steps 20 --seq 32 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \\
        --full-config --layers 4 --mesh 2,2 --steps 2 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
        --device cpu --mesh 2,2 --steps 2 --log-every 1
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \\
        --full-config --layers 2 --mesh 2,1,2 --steps 2 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper_base \\
        --full-config --mesh 2,2 --frames 1500 --steps 2 --batch 8 --seq 448

The batches are the reference's, array for array (:func:`data_stream`), and
the log lines are its own.  An encoder-decoder needs ``--frames N``: each
batch then carries N frame embeddings a row from the seed, as the
reference's ``train_4k`` cell takes them (a decoder's frontend is stubbed
out as ``repro.launch.train`` does).

``--mesh DATA,MODEL`` (default ``1,1``, the one-process run above) trains
on DATA x MODEL ranks of a ("data", "model") mesh, and ``--mesh
POD,DATA,MODEL`` on a ("pod", "data", "model") one, the reference's
``train_4k`` program: processes of this module in a gloo group
(``launch.ranks``; on one card they share it).  Each rank builds its blocks
of the parameters by the "train" rules from seed 0
(``launch.mesh.build_params(..., mode="train")``: each matrix's "model"
block, as serving runs it, cut again over the batch axes, ("pod", "data")
pod-major, the FSDP dimension) and of both AdamW moments, takes its rows
of each microbatch of the same batches (an encoder-decoder's frames with
them), gathers each leaf over the batch axes where a layer uses it and
reduces its gradient back to its block (``models.optim``, ``Sharding``),
and logs the loss and grad_norm of all the rows; rank 0's log lines are
printed.  Then :func:`reference` trains the one-process model on the same
weights and batches, :func:`summary` prints both and :func:`check` holds
the ranks to it.  ``--ckpt-dir`` with a mesh raises
``NotImplementedError``: the reference writes whole leaves from one
process, and a sharded checkpoint is no behaviour of it (ROADMAP A3.8).
"""

from __future__ import annotations

import argparse
import collections
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch import ranks as rank_procs

SEED = 0            # the weights' generator
DATA_SEED = 1234    # the batches', as the reference's


def data_stream(vocab: int, batch: int, seq: int, seed: int, start_step: int, device=None,
                frames: int = 0, d_model: int = 0):
    """Deterministic synthetic LM batches (restart-safe: keyed by step), the
    reference's: numpy's ``default_rng((seed, step))``; int64 tensors on
    ``device`` (``cuda`` unless it says otherwise).  With ``frames``, an
    encoder-decoder's batch also carries ``frontend_embeds`` (batch,
    frames, d_model), standard normal fp32 from ``default_rng((seed, step,
    1))``, where the reference's ``train_4k`` cell takes precomputed frame
    embeddings of that shape."""
    from repro_torch.core.device import resolve_device
    device = resolve_device(device)
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        toks = rng.integers(1, vocab, size=(batch, seq + 1), dtype=np.int64)
        out = {
            "tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(device),
        }
        if frames:
            fe = np.random.default_rng((seed, step, 1)).standard_normal((batch, frames, d_model))
            out["frontend_embeds"] = torch.from_numpy(fe.astype(np.float32)).to(device)
        yield out
        step += 1


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full published config")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this (0: all)")
    ap.add_argument("--config", action="append", default=[], metavar="FIELD=INT",
                    help="set an integer field of the config (repeatable)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="1,1", metavar="DATA,MODEL|POD,DATA,MODEL",
                    help="train on the ranks of a ('data', 'model') or ('pod', 'data', "
                         "'model') mesh")
    ap.add_argument("--frames", type=int, default=0,
                    help="frame embeddings a row for an encoder-decoder (which needs them)")
    rank_procs.add_rank_args(ap)
    return ap.parse_args(argv)


def mesh_shape(args: argparse.Namespace) -> Tuple[int, ...]:
    """The sizes of ``--mesh``: (DATA, MODEL) or (POD, DATA, MODEL)."""
    try:
        sizes = tuple(int(n) for n in args.mesh.split(","))
    except ValueError:
        sizes = ()
    if len(sizes) not in (2, 3):
        raise ValueError(f"--mesh takes DATA,MODEL or POD,DATA,MODEL, got {args.mesh!r}")
    if min(sizes) < 1:
        raise ValueError(f"--mesh {args.mesh}: each size must be at least 1")
    return sizes


def mesh_axes(args: argparse.Namespace):
    """The ``launch.mesh.MeshAxes`` of ``--mesh``."""
    from repro_torch.launch.mesh import MeshAxes
    sizes = mesh_shape(args)
    return MeshAxes(("pod", "data", "model")[-len(sizes):], sizes)


def model_config(args: argparse.Namespace, quiet: bool = False):
    """The trained config: ``--arch``, full or reduced, cut to ``--layers``,
    with the ``--config`` fields set; a decoder's frontend stubbed as the
    reference does, an encoder-decoder's fed ``--frames`` (which it needs,
    and nothing else takes)."""
    from repro_torch.configs import get_config, get_reduced_config
    cfg = (get_config if args.full_config else get_reduced_config)(args.arch)
    if cfg.is_enc_dec != bool(args.frames):
        raise ValueError(f"{args.arch}: " + ("an encoder-decoder trains on frames: give "
                                             "--frames" if cfg.is_enc_dec else
                                             "--frames feeds an encoder-decoder only"))
    if cfg.frontend is not None and not cfg.is_enc_dec:
        if not quiet:
            print(f"note: {args.arch} frontend is stubbed; training "
                  f"text-only on the backbone")
        cfg = cfg.replace(frontend=None, frontend_tokens=0)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers, layer_pattern=None)
    if args.config:
        cfg = cfg.replace(**{k: int(v) for k, v in (kv.split("=", 1) for kv in args.config)})
    return cfg


def setup(args: argparse.Namespace):
    """(cfg, model, params): :func:`model_config` and fp32 parameters from
    seed 0 on ``args.device``."""
    from repro_torch.core.device import resolve_device
    from repro_torch.models.transformer import build_model

    cfg = model_config(args)
    model = build_model(cfg)
    print(f"arch={cfg.arch_id}  params={cfg.param_count():,}")
    params = model.init(torch.Generator(resolve_device(args.device)).manual_seed(SEED),
                        torch.float32)
    return cfg, model, params


def run(args: argparse.Namespace, cfg, model, params, *, sharding=None, keep: bool = False,
        say=print) -> Dict:
    """Train ``params`` (in place) from the newest checkpoint in
    ``args.ckpt_dir``, if any, to ``args.steps``; on a rank of a mesh,
    ``params`` are its blocks and ``sharding`` says how it holds them
    (``models.optim.Sharding``).  Returns {"params", "opt", "history": one
    {"step", "loss", "grad_norm", "lr", "seconds", "launches", "gathered",
    "reduced", "census"} per step, "seconds", "lines": the log lines ``say``
    was given}, and with ``keep`` also "grads", step 1's gradients, fp32
    copies on the CPU; a step's seconds run to the read of its loss, its
    launches are the kernels' (``ops.launch_counts``), its "gathered" and
    "reduced" bytes its collectives' over "data" (``layers.GATHERED["fsdp"]``,
    ``layers.REDUCED``) and its "census" every collective it issued
    (``layers.collective_census``)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.models.optim import OptimizerConfig, init_adamw, make_train_step, tree_map
    lines: List[str] = []

    def log(line):
        lines.append(line)
        say(line)

    opt = init_adamw(params)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              sharding=sharding)
    start = 0
    if args.ckpt_dir:
        s = latest_step(args.ckpt_dir)
        if s is not None:
            params, opt, meta = restore_checkpoint(args.ckpt_dir, s, params, opt)
            start = int(meta["step"])
            log(f"restored checkpoint @ step {start}")

    stream = data_stream(cfg.vocab_size, args.batch, args.seq, seed=DATA_SEED,
                         start_step=start, device=args.device, frames=args.frames,
                         d_model=cfg.d_model)
    out: Dict = {"lines": lines}

    def keep_grads(grads):
        out["grads"] = tree_map(lambda g: g.detach().float().cpu().clone(), grads)

    history = []
    t0 = time.time()
    tokens_done = 0
    for step in range(start, args.steps):
        t_step = time.time()
        batch = next(stream)
        launches = collections.Counter(ops.launch_counts())
        layers.GATHERED.pop("fsdp", None)
        layers.REDUCED.clear()
        layers.COLLECTIVES.clear()
        params, opt, metrics = step_fn(params, opt, batch,
                                       on_grads=keep_grads if keep and step == start else None)
        tokens_done += args.batch * args.seq
        loss = float(metrics["loss"])
        history.append({"step": step + 1, "loss": loss,
                        "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(metrics["lr"]), "seconds": time.time() - t_step,
                        "launches": dict(collections.Counter(ops.launch_counts()) - launches),
                        "gathered": layers.GATHERED.get("fsdp", 0),
                        "reduced": dict(layers.REDUCED),
                        "census": layers.collective_census()})
        if (step + 1) % args.log_every == 0:
            tps = tokens_done / (time.time() - t0)
            log(f"step {step + 1:5d}  loss {loss:8.4f}  "
                f"grad_norm {history[-1]['grad_norm']:8.3f}  lr {history[-1]['lr']:.2e}  "
                f"{tps:,.0f} tok/s")
            if not np.isfinite(loss):
                raise RuntimeError(f"training diverged: loss {loss} at step {step + 1}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, step + 1, params, opt)
            log(f"checkpoint -> {path}")

    seconds = time.time() - t0
    log(f"done: {args.steps - start} steps in {seconds:.1f}s")
    out.update(params=params, opt=opt, history=history, seconds=seconds)
    return out


# --------------------------------------------------------------------------
# ranks of a ("data", "model") mesh
# --------------------------------------------------------------------------

def _refuse(args: argparse.Namespace) -> None:
    """Raise for what the ranks do not write: a sharded checkpoint, which
    ``repro.launch.train`` has no counterpart of (ROADMAP A3.8)."""
    if args.ckpt_dir:
        raise NotImplementedError("--ckpt-dir with --mesh: the reference writes whole leaves "
                                  "from one process only; a sharded checkpoint is not "
                                  "reference behaviour (ROADMAP A3.8)")


def rank_model(cfg, dm):
    """(the model of ``cfg``, the ``models.optim.Sharding`` of this rank of
    the device mesh ``dm``: ``launch.mesh.train_sharding`` of the whole
    tree on the meta device)."""
    from repro_torch.launch import mesh
    from repro_torch.models.transformer import build_model
    model = build_model(cfg)
    whole = model.init(torch.Generator().manual_seed(SEED), torch.float32, device="meta")
    return model, mesh.train_sharding(whole, dm)


def run_rank(args: argparse.Namespace) -> None:
    """One rank: join the group, build its blocks of the parameters by the
    "train" rules and of the moments, train, save."""
    from repro_torch.launch import mesh
    axes = mesh_axes(args)
    world = int(np.prod(mesh_shape(args)))
    with rank_procs.joined(args, world):
        device = rank_procs.rank_device(args.device, args.rank)
        dm = mesh.device_mesh(axes, device.type)
        with mesh.use_mesh(dm):
            cfg = model_config(args, quiet=True)
            _refuse(args)
            model, sharding = rank_model(cfg, dm)
            # raises for a placement no layer runs (model_placements)
            params, param_bytes, built = rank_procs.build_in_turns(
                device, args.rank, world,
                lambda: rank_procs.rank_params(model, device, torch.float32, SEED, mode="train"))
            moment_bytes = _moment_bytes(params, device)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            out = run(args, cfg, model, params, sharding=sharding, keep=True,
                      say=print if args.rank == 0 else (lambda _: None))
        res = {k: out[k] for k in ("history", "lines", "grads", "seconds")}
        res.update(rank=args.rank, coords=(sharding.rank, mesh.model_coordinate(dm)[0]),
                   build_seconds=built, params=_shapes(out["params"]),
                   param_bytes=param_bytes, moment_bytes=moment_bytes,
                   memory=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        rank_procs.save(args, res)


def _moment_bytes(params, device) -> int:
    """The bytes that the AdamW state of ``params`` allocates on the card,
    built and freed here (``run`` builds the same)."""
    from repro_torch.models.optim import init_adamw
    before = rank_procs.allocated(device)
    opt = init_adamw(params)
    grown = rank_procs.allocated(device) - before
    del opt
    return grown


def launch(args: argparse.Namespace) -> List[Dict]:
    """Start the rank processes of ``--mesh``, wait for all of them, and
    return each rank's results, in rank order (rank d·MODEL + m at batch
    coordinate d, pod-major, and "model" coordinate m); raises if one
    fails."""
    argv = ["--arch", args.arch, "--layers", str(args.layers), "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--microbatches", str(args.microbatches), "--lr", str(args.lr),
            "--log-every", str(args.log_every), "--device", args.device, "--mesh", args.mesh,
            "--frames", str(args.frames)]
    argv += (["--full-config"] if args.full_config else []) + [
        a for kv in args.config for a in ("--config", kv)]
    return rank_procs.launch("repro_torch.launch.train", argv, int(np.prod(mesh_shape(args))))


def reference(args: argparse.Namespace) -> Dict:
    """The same steps on the same weights and batches in one process: what
    :func:`launch`'s ranks are held against (``run`` with ``keep``)."""
    from repro_torch.models.transformer import build_model
    device = rank_procs.rank_device(args.device)
    cfg = model_config(args, quiet=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(SEED), torch.float32)
    out = run(args, cfg, model, params, keep=True, say=lambda _: None)
    return {k: out[k] for k in ("history", "grads", "seconds")}


def witness(args: argparse.Namespace) -> Dict[str, torch.Tensor]:
    """{leaf: step 1's gradient} of the one process in float64, through the
    plain versions, on the same weights (drawn in fp32 from the seed, then
    widened) and batch as :func:`reference`: near enough the exact gradient
    to tell how far each fp32 run (the ranks', the one process's) lies from
    it.  An SSD model's plain path keeps fp64 throughout
    (``layers.at_least_f32``); a config with any other layer raises, since
    its plain path rounds through fp32."""
    from repro_torch.launch import mesh
    from repro_torch.models.optim import tree_map, value_and_grad
    from repro_torch.models.transformer import build_model
    cfg = model_config(args, quiet=True)
    if set(cfg.layer_pattern) != {"ssd"}:
        raise ValueError(f"{cfg.arch_id}: only an SSD model's plain path keeps float64")
    device = rank_procs.rank_device(args.device)
    model = build_model(cfg)
    params = tree_map(lambda p: p.double(), model.init(
        torch.Generator(device).manual_seed(SEED), torch.float32))
    batch = next(data_stream(cfg.vocab_size, args.batch, args.seq, seed=DATA_SEED, start_step=0,
                             device=device, frames=args.frames, d_model=cfg.d_model))
    _, _, grads = value_and_grad(model, params, batch, microbatches=args.microbatches,
                                 force="plain")
    return dict(mesh.leaves_with_names(tree_map(lambda g: g.detach().cpu(), grads)))


def _whole_meta(args: argparse.Namespace):
    """The whole parameter tree on the meta device."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.transformer import build_model
    with use_mesh(None):
        return build_model(model_config(args, quiet=True)).init(
            torch.Generator().manual_seed(SEED), torch.float32, device="meta")


def expected(args: argparse.Namespace):
    """What each rank must hold of the parameters: ({leaf: shape} of its
    blocks, the bytes of each), the :func:`~repro_torch.launch.mesh.shard_shape`
    of each leaf's "train" placement at the mesh's sizes, from the whole
    tree on the meta device, after ``model_placements`` has said that every
    placement runs."""
    from repro_torch.launch import mesh
    axes = mesh_axes(args)
    whole = _whole_meta(args)
    mesh.model_placements(whole, axes.model_size(), "train", axes.sizes["data"],
                          axes.sizes.get("pod", 1))
    spec_of = mesh.named_specs(mesh.param_specs(whole, axes, "train"))
    shapes = {name: mesh.shard_shape(tuple(leaf.shape), spec_of[name], axes)
              for name, leaf in mesh.leaves_with_names(whole)}
    sizes = [int(np.prod(shapes[name])) * leaf.element_size()
             for name, leaf in mesh.leaves_with_names(whole)]
    return shapes, sizes


def kernel_launches(args: argparse.Namespace) -> Dict[str, int]:
    """The kernel launches of a step on every rank on the card: with remat,
    each attention layer's K1 twice a microbatch (the forward, and again in
    the backward) and K1's gradient kernel once, each SSD layer's K3 and
    K3's gradient kernel the same; an encoder-decoder's decoder layers
    attend twice (themselves and the frames), its encoder layers, outside
    remat, run K1 and its gradient kernel once each."""
    cfg = model_config(args, quiet=True)
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_pattern)
    n_ssd = sum(kind == "ssd" for kind in cfg.layer_pattern)
    n_enc = 0
    if cfg.is_enc_dec:
        n_attn, n_enc = 2 * cfg.num_layers, cfg.encoder.num_layers
    mb = args.microbatches
    return {"flash_attention": (2 * n_attn + n_enc) * mb,
            "flash_attention_bwd": (n_attn + n_enc) * mb,
            "ssd_scan": 2 * n_ssd * mb, "ssd_scan_bwd": n_ssd * mb}


def _rel(got: float, exp: float) -> float:
    return abs(got - exp) / max(abs(exp), 1e-30)


def leaf_errors(got: Dict[str, torch.Tensor], exp: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{leaf: the largest distance of ``got``'s leaf from ``exp``'s,
    relative to the largest entry of ``exp``'s}."""
    return {name: float((got[name] - e).abs().max()) / max(float(e.abs().max()), 1e-30)
            for name, e in exp.items()}


def summary(args: argparse.Namespace, ranks: List[Dict], ref: Dict,
            errs: Dict[str, float]) -> List[str]:
    """One line a step: the loss and grad_norm of rank 0 and of one process,
    each rank's ms and the one process's, the bytes a rank gathered and
    reduced over "data"; then step 1's gradients' largest distance from one
    process's, ``errs`` (:func:`gradient_errors`), by leaf (the three
    farthest)."""
    lines = []
    for t, h in enumerate(ranks[0]["history"]):
        e = ref["history"][t]
        lines.append(
            f"step {h['step']}: loss {h['loss']:.6f} (one process {e['loss']:.6f}, "
            f"{_rel(h['loss'], e['loss']):.3e} apart), grad_norm {h['grad_norm']:.6f} "
            f"({e['grad_norm']:.6f}, {_rel(h['grad_norm'], e['grad_norm']):.3e}); ms by rank "
            f"{[round(r['history'][t]['seconds'] * 1e3, 1) for r in ranks]}, one process "
            f"{e['seconds'] * 1e3:.1f}; over 'data' each rank gathered "
            f"{[r['history'][t]['gathered'] for r in ranks]} bytes and reduced "
            f"{[sum(r['history'][t]['reduced'].values()) for r in ranks]}")
    far = sorted(errs, key=errs.get, reverse=True)[:3]
    lines.append("step 1's gradients: every leaf within "
                 f"{errs[far[0]]:.3e} of its largest entry of the one process's (the farthest "
                 + ", ".join(f"{n} {errs[n]:.3e}" for n in far) + ")")
    return lines


def rank_gradients(args: argparse.Namespace, ranks: List[Dict]) -> Dict[str, torch.Tensor]:
    """{leaf: step 1's gradient} put together from the ranks' blocks
    (``mesh.whole_leaves``)."""
    from repro_torch.launch import mesh
    axes = mesh_axes(args)
    return mesh.whole_leaves(_whole_meta(args), axes.sizes["data"], axes.model_size(),
                             [r["grads"] for r in ranks], axes.sizes.get("pod", 1))


def gradient_errors(args: argparse.Namespace, ranks: List[Dict], ref: Dict) -> Dict[str, float]:
    """:func:`leaf_errors` of step 1's gradients, put together from the
    ranks' blocks, against the one process's."""
    from repro_torch.launch import mesh
    return leaf_errors(rank_gradients(args, ranks), dict(mesh.leaves_with_names(ref["grads"])))


def check(args: argparse.Namespace, ranks: List[Dict], ref: Dict, errs: Dict[str, float], *,
          loss_tol: float, norm_tol: float, leaf_tol: float) -> collections.Counter:
    """Raise unless the ranks trained as they should: each holds its blocks
    of the parameters (:func:`expected`; on the card, the allocation's bytes
    within ``parallel.allocation_bounds`` of them, and the moments' twice
    them and the step's scalar); every step's loss and grad_norm are the
    same on every rank (1e-6 relative) and within ``loss_tol`` and
    ``norm_tol`` of the one process's; step 1's gradients, put together
    from the blocks, within ``leaf_tol`` of each one-process leaf's largest
    entry (``errs``: :func:`gradient_errors`); on the card every step launched on every rank the kernels of
    :func:`kernel_launches`.  Returns the ranks' kernel launches, summed."""
    from repro_torch.launch.parallel import allocation_bounds
    shapes, sizes = expected(args)
    cuda = args.device != "cpu"
    per_step = {k: n for k, n in kernel_launches(args).items() if n}
    launches: collections.Counter = collections.Counter()
    for r in ranks:
        who = f"rank {r['rank']} {r['coords']}"
        if r["params"] != shapes:
            wrong = {n: (r["params"].get(n), shapes.get(n)) for n in set(shapes) | set(r["params"])
                     if r["params"].get(n) != shapes.get(n)}
            raise AssertionError(f"{who}'s parameters are not its blocks: {wrong}")
        if cuda:
            for what, got, want in (("parameters", r["param_bytes"], sizes),
                                    ("moments", r["moment_bytes"], sizes + sizes + [4])):
                least, most = allocation_bounds(want)
                if not least <= got <= most:
                    raise AssertionError(f"{who}'s {what} allocated {got} bytes, not "
                                         f"{sum(want)} rounded ({least} .. {most})")
        for t, h in enumerate(r["history"]):
            e, first = ref["history"][t], ranks[0]["history"][t]
            for key, tol in (("loss", loss_tol), ("grad_norm", norm_tol)):
                if _rel(h[key], first[key]) > 1e-6 or not np.isfinite(h[key]):
                    raise AssertionError(f"{who} step {h['step']}: {key} {h[key]}, rank 0's "
                                         f"{first[key]}")
                if _rel(h[key], e[key]) > tol:
                    raise AssertionError(f"{who} step {h['step']}: {key} {h[key]}, one process "
                                         f"{e[key]} (> {tol} apart)")
            if cuda and any(h["launches"].get(k, 0) != n for k, n in per_step.items()):
                raise AssertionError(f"{who} step {h['step']}: launched {h['launches']}, not "
                                     f"{per_step}")
            launches.update(h["launches"])
    far = {n: e for n, e in errs.items() if not e <= leaf_tol}
    if far:
        raise AssertionError(f"step 1's gradients: leaves farther than {leaf_tol} from one "
                             f"process's: {far}")
    return launches


def _shapes(tree) -> Dict[str, tuple]:
    from repro_torch.launch.mesh import leaves_with_names
    return {name: tuple(leaf.shape) for name, leaf in leaves_with_names(tree)}


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.rank >= 0:
        run_rank(args)
        return
    if np.prod(mesh_shape(args)) == 1:
        cfg, model, params = setup(args)
        run(args, cfg, model, params)
        return
    _refuse(args)
    ranks = launch(args)
    for line in ranks[0]["lines"]:
        print(line)
    ref = reference(args)
    errs = gradient_errors(args, ranks, ref)
    for line in summary(args, ranks, ref, errs):
        print(line)
    check(args, ranks, ref, errs, loss_tol=1e-4, norm_tol=1e-3, leaf_tol=1e-3)


if __name__ == "__main__":
    main()
