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

The batches are the reference's, array for array (:func:`data_stream`), and
the log lines are its own.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def data_stream(vocab: int, batch: int, seq: int, seed: int, start_step: int, device=None):
    """Deterministic synthetic LM batches (restart-safe: keyed by step), the
    reference's: numpy's ``default_rng((seed, step))``; int64 tensors on
    ``device`` (``cuda`` unless it says otherwise)."""
    from repro_torch.core.device import resolve_device
    device = resolve_device(device)
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        toks = rng.integers(1, vocab, size=(batch, seq + 1), dtype=np.int64)
        yield {
            "tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(device),
        }
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
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """(cfg, model, params): the architecture, full or reduced, its frontend
    stubbed as the reference does, and fp32 parameters from seed 0 on
    ``args.device``."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.core.device import resolve_device
    from repro_torch.models.transformer import build_model

    cfg = (get_config if args.full_config else get_reduced_config)(args.arch)
    if cfg.frontend is not None:
        print(f"note: {args.arch} frontend is stubbed; training "
              f"text-only on the backbone")
        cfg = cfg.replace(frontend=None, frontend_tokens=0)
    model = build_model(cfg)
    print(f"arch={cfg.arch_id}  params={cfg.param_count():,}")
    params = model.init(torch.Generator(resolve_device(args.device)).manual_seed(0),
                        torch.float32)
    return cfg, model, params


def run(args: argparse.Namespace, cfg, model, params) -> Dict:
    """Train ``params`` (in place) from the newest checkpoint in
    ``args.ckpt_dir``, if any, to ``args.steps``.  Returns {"params",
    "opt", "history": one {"step", "loss", "grad_norm", "lr", "seconds"}
    per step, "seconds"}; a step's seconds run to the read of its loss."""
    from repro_torch.models.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.models.optim import OptimizerConfig, init_adamw, make_train_step

    opt = init_adamw(params)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)

    start = 0
    if args.ckpt_dir:
        s = latest_step(args.ckpt_dir)
        if s is not None:
            params, opt, meta = restore_checkpoint(args.ckpt_dir, s, params, opt)
            start = int(meta["step"])
            print(f"restored checkpoint @ step {start}")

    stream = data_stream(cfg.vocab_size, args.batch, args.seq, seed=1234, start_step=start,
                         device=args.device)
    history = []
    t0 = time.time()
    tokens_done = 0
    for step in range(start, args.steps):
        t_step = time.time()
        batch = next(stream)
        params, opt, metrics = step_fn(params, opt, batch)
        tokens_done += args.batch * args.seq
        loss = float(metrics["loss"])
        history.append({"step": step + 1, "loss": loss,
                        "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(metrics["lr"]), "seconds": time.time() - t_step})
        if (step + 1) % args.log_every == 0:
            tps = tokens_done / (time.time() - t0)
            print(f"step {step + 1:5d}  loss {loss:8.4f}  "
                  f"grad_norm {history[-1]['grad_norm']:8.3f}  lr {history[-1]['lr']:.2e}  "
                  f"{tps:,.0f} tok/s")
            if not np.isfinite(loss):
                raise RuntimeError(f"training diverged: loss {loss} at step {step + 1}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, step + 1, params, opt)
            print(f"checkpoint -> {path}")

    seconds = time.time() - t0
    print(f"done: {args.steps - start} steps in {seconds:.1f}s")
    return {"params": params, "opt": opt, "history": history, "seconds": seconds}


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    cfg, model, params = setup(args)
    run(args, cfg, model, params)


if __name__ == "__main__":
    main()
