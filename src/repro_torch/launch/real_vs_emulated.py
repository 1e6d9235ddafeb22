"""Real execution against time-warp emulation of the same engine on the same
request stream: the paper's fidelity measurement, with the real side on the
card.

    # llama3_8b at full width and depth, bf16, one H100:
    PYTHONPATH=src python -m repro_torch.launch.real_vs_emulated

    # the reduced llama3_8b on the CPU, on 8 short requests (a rehearsal;
    # its times are CPU times):
    PYTHONPATH=src python -m repro_torch.launch.real_vs_emulated --reduced \\
        --device cpu --dtype float32

Three phases, on the engine configuration of ``serve.engine_config`` (vllm,
8 slots, a 512-token budget, no prefix caching, an emulated H100) and
streams from ``workload.synthesize`` (``STREAM``; seed 1 calibrates, seed 2
evaluates):

1. real mode: a calibration stream, then a separate evaluation stream, each
   through its own ``build_stack(mode="real")``;
2. ``LinearPredictor().fit`` on the calibration steps only;
3. emulate mode on the evaluation stream, once with the fitted predictor and
   once with ``default_predictor`` (the analytical model of the engine's
   chip), on the real wall clock, so that its wall time is comparable.

It reports TTFT and TPOT at p50 and p99 of every run, the percentile errors
of each emulated run against the real one (``compare_distributions``), the
wall times and the speed-up, and for each phase its steps, its kernel
launches and, on the card, the change in allocated device memory.  It checks
that every request of every run finished and that each real request got its
``max_new_tokens`` tokens, each in ``[0, vocab)``; it asserts nothing about
the size of the errors.  The weights are random, made from seed 0.
"""

from __future__ import annotations

import argparse
import gc
from typing import Dict, List, Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.predictor import LinearPredictor
from repro_torch.kernels import ops
from repro_torch.launch.serve import engine_config
from repro_torch.metrics import compare_distributions
from repro_torch.models.config import ModelConfig
from repro_torch.serving.benchmark import BenchmarkResult, BenchmarkRunner
from repro_torch.serving.request import Request
from repro_torch.serving.stack import build_stack, default_predictor
from repro_torch.workload import WorkloadConfig, synthesize

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

ARCH = "llama3_8b"
MAX_LEN = 2048
# both streams: Poisson arrivals, lognormal lengths
STREAM = dict(num_requests=32, qps=2.0, prompt_len_mean=256, output_len_mean=32,
              max_prompt_len=1024, max_output_len=64)
# the CPU rehearsal's, on the reduced model
REDUCED_MAX_LEN = 256
REDUCED_STREAM = dict(num_requests=8, qps=20.0, prompt_len_mean=48, output_len_mean=8,
                      max_prompt_len=128, max_output_len=16)
CALIBRATION_SEED, EVALUATION_SEED, WEIGHTS_SEED = 1, 2, 0


def workload(model_cfg: ModelConfig, seed: int, stream: Dict) -> List[Request]:
    return synthesize(WorkloadConfig(**stream, vocab_size=model_cfg.vocab_size,
                                     seed=seed))


def _latencies(res: BenchmarkResult) -> Dict[str, float]:
    return {"ttft_p50_s": res.ttft.p50, "ttft_p99_s": res.ttft.p99,
            "tpot_p50_s": res.tpot.p50, "tpot_p99_s": res.tpot.p99,
            "makespan_virtual_s": res.makespan_virtual,
            "wall_s": res.wall_seconds, "num_requests": res.num_requests}


class _Phase:
    """Kernel launches and allocated device memory around one run: the
    launch counts are set to 0 at the start and read at the end."""

    def __init__(self, device: Optional[torch.device]):
        self.cuda = device is not None and device.type == "cuda"

    def __enter__(self) -> "_Phase":
        gc.collect()
        self.mem0 = torch.cuda.memory_allocated() if self.cuda else None
        ops.reset_launch_counts()
        return self

    def __exit__(self, *exc) -> None:
        self.launches = ops.launch_counts()
        self.mem_delta = (torch.cuda.memory_allocated() - self.mem0
                          if self.cuda else None)

    def record(self, res: BenchmarkResult, steps: int) -> Dict:
        return {**_latencies(res), "steps": steps, "launches": self.launches,
                "allocated_delta_bytes": self.mem_delta}


def serve_real(model_cfg, engine_cfg, model, params, reqs, *, max_len, device,
               dtype, timeout):
    """One stream in real mode on its own stack; returns the result, the
    step samples and the phase record."""
    stack = build_stack(model_cfg, engine_cfg, "real", model=model, params=params,
                        max_len=max_len, device=device, dtype=dtype)
    with _Phase(device) as phase:
        try:
            res = BenchmarkRunner(stack.engine, reqs).run(timeout=timeout)
        finally:
            stack.shutdown()
    for r in reqs:
        if (not r.finished or r.num_generated != r.max_new_tokens
                or not all(0 <= t < model_cfg.vocab_size for t in r.output_tokens)):
            raise RuntimeError(f"real request {r.request_id}: {r.num_generated} of "
                               f"{r.max_new_tokens} tokens, finished={r.finished}")
    samples = list(stack.runner.samples)
    record = phase.record(res, len(stack.engine.step_log))
    del stack
    return res, samples, record


def serve_emulated(model_cfg, engine_cfg, predictor, reqs, *, device, timeout):
    """One stream under time-warp emulation: no device, no tensor."""
    with _Phase(device) as phase:
        stack = build_stack(model_cfg, engine_cfg, "emulate", predictor=predictor,
                            use_worker_group=False)
        try:
            res = BenchmarkRunner(stack.engine, reqs,
                                  transport=stack.transport).run(timeout=timeout)
        finally:
            stack.shutdown()
        steps = len(stack.engine.step_log)
        del stack
    if not all(r.finished for r in reqs):
        raise RuntimeError("an emulated request did not finish")
    return res, phase.record(res, steps)


def run(model_cfg: ModelConfig, model, params, *, stream: Dict = STREAM,
        max_len: int = MAX_LEN, device=None, dtype=torch.bfloat16,
        timeout: float = 600.0) -> Dict:
    """The three phases.  The evaluation stream is made anew for each run
    (a request is served once)."""
    device = resolve_device(device)
    engine_cfg = engine_config(max_len=max_len)
    real_kw = dict(max_len=max_len, device=device, dtype=dtype, timeout=timeout)

    def evaluation():
        return workload(model_cfg, EVALUATION_SEED, stream)

    _, samples, calib_rec = serve_real(
        model_cfg, engine_cfg, model, params,
        workload(model_cfg, CALIBRATION_SEED, stream), **real_kw)
    real_res, _, real_rec = serve_real(model_cfg, engine_cfg, model, params,
                                       evaluation(), **real_kw)
    linear = LinearPredictor()
    linear.fit(samples)
    report = {"arch": model_cfg.arch_id, "device": str(device),
              "dtype": str(dtype).replace("torch.", ""),
              "calibration": calib_rec, "real": real_rec,
              "linear_coef": [float(c) for c in linear._coef],
              "linear_features": ["1", "prefill_tokens", "decode_seqs", "total_context"]}
    for name, pred in (("linear", linear),
                       ("analytical", default_predictor(model_cfg, engine_cfg))):
        res, rec = serve_emulated(model_cfg, engine_cfg, pred, evaluation(),
                                  device=device, timeout=timeout)
        rec["ttft_err"] = compare_distributions(real_res.ttft, res.ttft)
        rec["tpot_err"] = compare_distributions(real_res.tpot, res.tpot)
        rec["speedup_x"] = real_res.wall_seconds / max(res.wall_seconds, 1e-9)
        report[f"emulate_{name}"] = rec
    return report


def format_report(report: Dict) -> List[str]:
    """Human-readable lines: latencies in ms, errors in percent."""
    lines = []
    for key in ("real", "emulate_linear", "emulate_analytical"):
        r = report[key]
        line = (f"{key:18s} TTFT p50 {r['ttft_p50_s'] * 1e3:9.3f} p99 "
                f"{r['ttft_p99_s'] * 1e3:9.3f} ms  TPOT p50 {r['tpot_p50_s'] * 1e3:8.3f} "
                f"p99 {r['tpot_p99_s'] * 1e3:8.3f} ms  wall {r['wall_s']:.3f} s  "
                f"steps {r['steps']}")
        if "ttft_err" in r:
            line += (f"  err TTFT p50 {100 * r['ttft_err']['p50_rel_err']:.2f}% p99 "
                     f"{100 * r['ttft_err']['p99_rel_err']:.2f}%  TPOT p50 "
                     f"{100 * r['tpot_err']['p50_rel_err']:.2f}% p99 "
                     f"{100 * r['tpot_err']['p99_rel_err']:.2f}%  speed-up "
                     f"{r['speedup_x']:.2f}x")
        lines.append(line)
    return lines


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config on a short stream (CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.models.transformer import build_model

    device = resolve_device(args.device)
    dtype = _DTYPES[args.dtype]
    model_cfg = (get_reduced_config if args.reduced else get_config)(ARCH)
    model = build_model(model_cfg)
    params = model.init(torch.Generator(device).manual_seed(WEIGHTS_SEED), dtype, device)
    report = run(model_cfg, model, params,
                 stream=REDUCED_STREAM if args.reduced else STREAM,
                 max_len=REDUCED_MAX_LEN if args.reduced else MAX_LEN,
                 device=device, dtype=dtype)
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
    for line in format_report(report):
        print(line)
    return report


if __name__ == "__main__":
    main()
