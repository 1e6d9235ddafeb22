"""Serving driver CLI: run a registry architecture through the port's engine
in any execution mode.

    # llama3_8b or mamba2_370m at full width and depth, bf16, one H100:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_370m

    # requests that share a 512-token system prompt, served from the prefix
    # cache after the first (an attention model: see F4-rec below):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b --shared-prefix 512

    # a reduced model on the CPU (a rehearsal; its times are CPU times):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
        --reduced --device cpu --dtype float32

    # GPU-free time-warp emulation of any of the 13 architectures at full
    # size, or of a 70B deployment over four chips, as the reference CLI:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b --mode emulate
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_70b \\
        --mode emulate --tp 4 --qps 2 --num-requests 100

    # the strawman sleep-based emulation (the paper's section 3.2):
    PYTHONPATH=src python -m repro_torch.launch.serve --mode sleep

Requests come from ``workload.synthesize`` (Poisson arrivals at ``--qps``,
lognormal prompt and output lengths, ``--shared-prefix`` tokens common to
every prompt) and results from ``BenchmarkRunner``.

The emulated modes (``emulate``, ``sleep``) build the reference CLI's
engine and workload exactly, so that the same flags give the same
timeline: 32768 blocks of 16 tokens with prefix caching on, and
``synthesize``'s own length caps (2048 and 1024) and vocabulary (32000).
Real mode serves the full model on one card, so it keeps sizes of its
own: blocks enough for every slot at ``--max-len`` (:func:`engine_config`),
lengths capped at half of ``--max-len`` so that every request fits its
slot, and the model's vocabulary.  It too serves with prefix caching on,
the runner keeping the cached blocks' KV.  A flag left out takes its
mode's default:

    flag              emulate, sleep    real
    --chip            h200-sxm          h100-sxm
    --max-num-seqs    64                8
    --num-requests    100               8
    --prompt-mean     220               256
    --output-mean     180               32

The emulated defaults are the reference CLI's; an emulated H100 cannot
hold its 32768-block pool beside llama3_8b's weights (a
``VirtualOOMError``), hence its H200.  Real mode's defaults fit one 80 GB
card.  ``--mode real`` is the default.  Real mode runs on the card unless
``--device`` names the CPU; its weights are random, made from ``--seed``.
A model with recurrent layers keeps no prefix store, so real mode refuses
it a shared prefix before it builds anything (ROADMAP F4-rec).  The
emulated modes touch no device and build no weights.

:func:`engine_config` is also the serving configuration of
``real_vs_emulated`` and of the smoke test, which keep prefix caching off;
``make_requests`` and ``run_requests`` serve a fixed list of requests all
at once, for the smoke test's serving phases.
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
from repro_torch.models.transformer import RECURRENT_KINDS, build_model
from repro_torch.serving.benchmark import BenchmarkRunner
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.serving.stack import ServingStack, build_stack
from repro_torch.workload import WorkloadConfig, synthesize

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# the defaults of the flags that differ by mode (see the module docstring)
DEFAULTS = {
    "emulated": dict(chip="h200-sxm", max_num_seqs=64, num_requests=100, prompt_mean=220.0,
                     output_mean=180.0),
    "real": dict(chip="h100-sxm", max_num_seqs=8, num_requests=8, prompt_mean=256.0,
                 output_mean=32.0),
}


def engine_config(max_num_seqs: int = 8, max_len: int = 2048, *, policy: str = "vllm",
                  chunk: int = 512, chip: str = "h100-sxm", tp: int = 1, pp: int = 1,
                  ep: int = 1, prefix_caching: bool = False) -> EngineConfig:
    """Real mode's engine: 16-token blocks enough for every slot at
    ``max_len``, a ``chunk``-token step budget, prefix caching as
    ``prefix_caching`` says (off for ``real_vs_emulated`` and the smoke
    test's serving phases; the CLI turns it on)."""
    return EngineConfig(policy=policy, max_num_seqs=max_num_seqs,
                        max_batched_tokens=chunk, block_size=16,
                        num_blocks=-(-max_num_seqs * max_len // 16),
                        enable_prefix_caching=prefix_caching, chip=chip, tp=tp, pp=pp, ep=ep)


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


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's flags, each left out taking its mode's default
    (:data:`DEFAULTS`)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--mode", default="real", choices=["real", "emulate", "sleep"])
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's reduced config (CPU rehearsal)")
    ap.add_argument("--device", default="cuda", help="real mode only")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    ap.add_argument("--policy", default="vllm", choices=["vllm", "sglang"])
    ap.add_argument("--chip", help="the emulated chip (h200-sxm emulated, h100-sxm real)")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--max-num-seqs", type=int, help="64 emulated, 8 real")
    ap.add_argument("--chunk", type=int, default=512,
                    help="max batched tokens (chunked-prefill budget)")
    ap.add_argument("--max-len", type=int, default=2048, help="real mode only")
    ap.add_argument("--num-requests", type=int, help="100 emulated, 8 real")
    ap.add_argument("--qps", type=float, default=2.0)
    ap.add_argument("--prompt-mean", type=float, help="220 emulated, 256 real")
    ap.add_argument("--output-mean", type=float, help="180 emulated, 32 real")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens every prompt starts with")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)
    for key, value in DEFAULTS["real" if args.mode == "real" else "emulated"].items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    return args


def main(argv=None) -> Dict:
    args = parse_args(argv)
    summary = dict(arch=args.arch, mode=args.mode, policy=args.policy)
    if args.mode == "real":
        model_cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
        recurrent = sorted(set(model_cfg.layer_pattern) & set(RECURRENT_KINDS))
        if args.shared_prefix and recurrent:
            raise ValueError(f"--shared-prefix {args.shared_prefix}: {model_cfg.arch_id} has "
                             f"{'/'.join(recurrent)} layers, whose state the prefix cache does "
                             "not hold, so a prefix hit cannot be served (ROADMAP F4-rec)")
        if args.shared_prefix >= args.max_len // 2:
            raise ValueError(f"--shared-prefix {args.shared_prefix} leaves no room in a prompt "
                             f"of at most --max-len // 2 = {args.max_len // 2} tokens")
        engine_cfg = engine_config(args.max_num_seqs, args.max_len, policy=args.policy,
                                   chunk=args.chunk, chip=args.chip, tp=args.tp, pp=args.pp,
                                   ep=args.ep, prefix_caching=True)
        device = resolve_device(args.device)
        dtype = _DTYPES[args.dtype]
        model = build_model(model_cfg)
        params = model.init(torch.Generator(device).manual_seed(args.seed), dtype)
        stack = build_stack(model_cfg, engine_cfg, "real", model=model, params=params,
                            max_seqs=args.max_num_seqs, max_len=args.max_len,
                            device=device, dtype=dtype)
        summary.update(arch=model_cfg.arch_id, device=str(device))
        if device.type == "cuda":
            summary["device_name"] = torch.cuda.get_device_name(device)
        # lengths that fit a slot, tokens of the model's vocabulary
        caps = dict(max_prompt_len=args.max_len // 2, max_output_len=args.max_len // 2,
                    vocab_size=model_cfg.vocab_size)
    else:
        model_cfg = get_config(args.arch)
        # the reference CLI's engine, prefix caching at its default (on)
        engine_cfg = EngineConfig(policy=args.policy, max_num_seqs=args.max_num_seqs,
                                  max_batched_tokens=args.chunk, block_size=16,
                                  num_blocks=32768, chip=args.chip, tp=args.tp, pp=args.pp,
                                  ep=args.ep)
        stack = build_stack(model_cfg, engine_cfg, args.mode)
        summary["chip"] = args.chip
        caps = {}                          # synthesize's own, as the reference CLI
    reqs = synthesize(WorkloadConfig(
        num_requests=args.num_requests, qps=args.qps,
        prompt_len_mean=args.prompt_mean, output_len_mean=args.output_mean,
        shared_prefix_len=args.shared_prefix, seed=args.seed, **caps))
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
