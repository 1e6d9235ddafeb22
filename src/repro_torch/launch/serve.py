"""Serving driver CLI: run a registry architecture through the port's engine
in real mode, on the card.

    # llama3_8b at full width and depth, bf16, one H100:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b

    # a reduced model on the CPU (a rehearsal; its times are CPU times):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
        --reduced --device cpu --dtype float32

The weights are random, made from ``--seed``.  Until the workload and metrics
modules are ported, the CLI makes a fixed list of requests from ``--seed``
with numpy, submits them all at once, waits for them, and reports TTFT and
TPOT from each request's own ``arrival_time``, ``first_token_time`` and
``token_times``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.serving.stack import ServingStack, build_stack

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_requests(num: int, prompt_min: int, prompt_max: int, max_new_tokens: int,
                  vocab_size: int, seed: int) -> List[Request]:
    """``num`` requests with prompt lengths uniform in [prompt_min,
    prompt_max] and random tokens, all from one numpy seed."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_min, prompt_max + 1, size=num)
    return [Request(prompt_tokens=rng.integers(0, vocab_size, size=int(n)).tolist(),
                    max_new_tokens=max_new_tokens) for n in lens]


def summarize(reqs: Sequence[Request], wall_s: float) -> Dict[str, float]:
    """Latency figures from the requests' own timestamps (seconds)."""
    done = [r for r in reqs if r.finished]
    ttft = np.array([r.ttft() for r in done])
    tpot = np.array([np.mean(np.diff(r.token_times)) for r in done
                     if len(r.token_times) > 1])
    out_tokens = sum(r.num_generated for r in done)
    nan = float("nan")
    return {
        "finished": len(done),
        "ttft_p50_s": float(np.percentile(ttft, 50)) if len(ttft) else nan,
        "ttft_p99_s": float(np.percentile(ttft, 99)) if len(ttft) else nan,
        "tpot_p50_s": float(np.percentile(tpot, 50)) if len(tpot) else nan,
        "output_tokens": out_tokens,
        "output_tokens_per_s": out_tokens / wall_s if wall_s > 0 else nan,
        "wall_s": wall_s,
    }


def run_requests(stack: ServingStack, reqs: List[Request],
                 timeout: float = 600.0) -> Dict[str, float]:
    """Submit every request at once to the started engine, wait for all of
    them, shut the stack down, and summarise."""
    engine = stack.engine
    try:
        engine.start()
        now = stack.clock.now()
        for r in reqs:
            r.arrival_time = now
        t0 = time.monotonic()
        engine.submit_many(reqs)
        # wait in short rounds, so that an engine thread that died on an
        # error ends the run at once instead of at the timeout
        while not engine.wait_until_complete(len(reqs), timeout=1.0):
            if not engine.is_running:
                raise RuntimeError("the engine thread stopped with requests "
                                   "unfinished (its error is printed above)")
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"{engine.finished_count} of {len(reqs)} "
                                   f"requests finished within {timeout} s")
        wall = time.monotonic() - t0
    finally:
        stack.shutdown()
    summary = summarize(reqs, wall)
    summary["steps"] = engine.stats()["steps"]
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--mode", default="real", choices=["real"])
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's reduced config (CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    ap.add_argument("--policy", default="vllm", choices=["vllm", "sglang"])
    ap.add_argument("--max-num-seqs", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=512,
                    help="max batched tokens (chunked-prefill budget)")
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--prompt-min", type=int, default=128)
    ap.add_argument("--prompt-max", type=int, default=1024)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args()

    device = resolve_device(args.device)
    dtype = _DTYPES[args.dtype]
    model_cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    engine_cfg = EngineConfig(
        policy=args.policy, max_num_seqs=args.max_num_seqs,
        max_batched_tokens=args.chunk, block_size=16,
        num_blocks=-(-args.max_num_seqs * args.max_len // 16),
        enable_prefix_caching=False, chip="h100-sxm")
    model = build_model(model_cfg)
    params = model.init(torch.Generator(device).manual_seed(args.seed), dtype)
    stack = build_stack(model_cfg, engine_cfg, "real", model=model, params=params,
                        max_seqs=args.max_num_seqs, max_len=args.max_len,
                        device=device, dtype=dtype)
    reqs = make_requests(args.num_requests, args.prompt_min, args.prompt_max,
                         args.max_new_tokens, model_cfg.vocab_size, args.seed)
    summary = dict(arch=model_cfg.arch_id, mode=args.mode, device=str(device),
                   **run_requests(stack, reqs))
    if device.type == "cuda":
        summary["device_name"] = torch.cuda.get_device_name(device)
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"  {k:24s} {v:,.6f}" if isinstance(v, float) else f"  {k:24s} {v}")


if __name__ == "__main__":
    main()
