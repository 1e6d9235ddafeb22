"""Serving driver CLI: run a registry architecture through the port's engine
in any execution mode.

    # llama3_8b or mamba2_370m at full width and depth, bf16, one H100:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_370m

    # a reduced model on the CPU (a rehearsal; its times are CPU times):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
        --reduced --device cpu --dtype float32

    # GPU-free time-warp emulation of an H100 serving any of the 13
    # architectures at full size, or of a 70B deployment over four of them:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b --mode emulate
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_70b \\
        --mode emulate --tp 4 --qps 2 --num-requests 100

    # the strawman sleep-based emulation (the paper's section 3.2):
    PYTHONPATH=src python -m repro_torch.launch.serve --mode sleep

Requests come from ``workload.synthesize`` (Poisson arrivals at ``--qps``,
lognormal prompt and output lengths, each at most half of ``--max-len``, so
that every request fits its slot) and results from ``BenchmarkRunner``.
Real mode runs on the card unless ``--device`` names the CPU; its weights
are random, made from ``--seed``.  The emulated modes touch no device and
build no weights.  ``engine_config`` is the serving configuration of this
CLI, of ``real_vs_emulated`` and of the smoke test; ``make_requests`` and
``run_requests`` serve a fixed list of requests all at once, for the smoke
test's serving phases.
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
from repro_torch.serving.benchmark import BenchmarkRunner
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.serving.stack import ServingStack, build_stack
from repro_torch.workload import WorkloadConfig, synthesize

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def engine_config(max_num_seqs: int = 8, max_len: int = 2048, *, policy: str = "vllm",
                  chunk: int = 512, chip: str = "h100-sxm", tp: int = 1, pp: int = 1,
                  ep: int = 1) -> EngineConfig:
    """16-token blocks enough for every slot at ``max_len``, a ``chunk``-token
    step budget, no prefix caching."""
    return EngineConfig(policy=policy, max_num_seqs=max_num_seqs,
                        max_batched_tokens=chunk, block_size=16,
                        num_blocks=-(-max_num_seqs * max_len // 16),
                        enable_prefix_caching=False, chip=chip, tp=tp, pp=pp, ep=ep)


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


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--mode", default="real", choices=["real", "emulate", "sleep"])
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's reduced config (CPU rehearsal)")
    ap.add_argument("--device", default="cuda", help="real mode only")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    ap.add_argument("--policy", default="vllm", choices=["vllm", "sglang"])
    ap.add_argument("--chip", default="h100-sxm", help="the emulated chip")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--max-num-seqs", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=512,
                    help="max batched tokens (chunked-prefill budget)")
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--qps", type=float, default=2.0)
    ap.add_argument("--prompt-mean", type=float, default=256.0)
    ap.add_argument("--output-mean", type=float, default=32.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)

    model_cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    engine_cfg = engine_config(args.max_num_seqs, args.max_len, policy=args.policy,
                               chunk=args.chunk, chip=args.chip, tp=args.tp,
                               pp=args.pp, ep=args.ep)
    summary = dict(arch=model_cfg.arch_id, mode=args.mode, policy=args.policy)
    if args.mode == "real":
        device = resolve_device(args.device)
        dtype = _DTYPES[args.dtype]
        model = build_model(model_cfg)
        params = model.init(torch.Generator(device).manual_seed(args.seed), dtype)
        stack = build_stack(model_cfg, engine_cfg, "real", model=model, params=params,
                            max_seqs=args.max_num_seqs, max_len=args.max_len,
                            device=device, dtype=dtype)
        summary["device"] = str(device)
        if device.type == "cuda":
            summary["device_name"] = torch.cuda.get_device_name(device)
    else:
        stack = build_stack(model_cfg, engine_cfg, args.mode)
        summary["chip"] = args.chip
    reqs = synthesize(WorkloadConfig(
        num_requests=args.num_requests, qps=args.qps,
        prompt_len_mean=args.prompt_mean, output_len_mean=args.output_mean,
        max_prompt_len=args.max_len // 2, max_output_len=args.max_len // 2,
        vocab_size=model_cfg.vocab_size, seed=args.seed))
    try:
        res = BenchmarkRunner(stack.engine, reqs,
                              transport=stack.transport).run(timeout=3600)
    finally:
        stack.shutdown()
    summary.update(res.summary())
    summary["steps"] = len(stack.engine.step_log)
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"  {k:24s} {v:,.6f}" if isinstance(v, float) else f"  {k:24s} {v}")
    return summary


if __name__ == "__main__":
    main()
