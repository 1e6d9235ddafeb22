"""Open-loop workload synthesis: request streams for fidelity benchmarks.

ShareGPT-like length marginals (lognormal prompt, lognormal output — the
shapes reported by Vidur/Splitwise trace studies) with a pluggable arrival
process (Poisson by default; see :mod:`repro.workload.arrival` for bursty /
on-off / diurnal traffic), plus deterministic trace replay and a
prefix-sharing workload (same system prompt across requests) for exercising
the radix cache.  Seeded and fully deterministic so real/sleep/emulate runs
see byte-identical request streams.

Closed-loop (multi-turn session) synthesis lives in
:mod:`repro.workload.session`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import Request

from .arrival import ArrivalProcess, make_arrival

__all__ = ["WorkloadConfig", "synthesize", "replay_trace",
           "lognormal_lengths"]


@dataclass(frozen=True)
class WorkloadConfig:
    num_requests: int = 100
    qps: float = 2.0                      # mean arrival rate
    arrival: str = "poisson"              # arrival-process registry name
    arrival_kwargs: Optional[dict] = None  # e.g. {"cv2": 8.0} for gamma
    prompt_len_mean: float = 220.0        # ShareGPT-ish
    prompt_len_sigma: float = 0.6         # lognormal sigma
    output_len_mean: float = 180.0
    output_len_sigma: float = 0.6
    max_prompt_len: int = 2048
    max_output_len: int = 1024
    min_prompt_len: int = 4
    min_output_len: int = 2
    vocab_size: int = 32000
    shared_prefix_len: int = 0            # >0: common system prompt
    seed: int = 0


def lognormal_lengths(rng: np.random.Generator, n: int, mean: float,
                      sigma: float, lo: int, hi: int) -> np.ndarray:
    mu = np.log(mean) - sigma**2 / 2
    lens = rng.lognormal(mu, sigma, size=n)
    return np.clip(lens.astype(int), lo, hi)


def synthesize(cfg: WorkloadConfig,
               arrival: Optional[ArrivalProcess] = None) -> List[Request]:
    """Generate ``cfg.num_requests`` open-loop requests.

    ``arrival`` overrides the config's registry lookup with a pre-built
    process object.  The draw order (arrival gaps, prompt lengths, output
    lengths, shared prefix, bodies) is frozen: for the default Poisson
    process every non-arrival draw is byte-identical to the historical
    single-process implementation (regression-pinned in
    tests/test_workload.py).
    """
    rng = np.random.default_rng(cfg.seed)
    n = cfg.num_requests

    proc = arrival or make_arrival(cfg.arrival, cfg.qps,
                                   **(cfg.arrival_kwargs or {}))
    arrivals = proc.sample(n, rng)

    prompt_lens = lognormal_lengths(rng, n, cfg.prompt_len_mean,
                                    cfg.prompt_len_sigma,
                                    cfg.min_prompt_len, cfg.max_prompt_len)
    output_lens = lognormal_lengths(rng, n, cfg.output_len_mean,
                                    cfg.output_len_sigma,
                                    cfg.min_output_len, cfg.max_output_len)

    shared = (rng.integers(1, cfg.vocab_size, size=cfg.shared_prefix_len)
              .tolist() if cfg.shared_prefix_len else [])

    reqs = []
    for i in range(n):
        body_len = max(int(prompt_lens[i]) - len(shared), 1)
        body = rng.integers(1, cfg.vocab_size, size=body_len).tolist()
        reqs.append(Request(
            prompt_tokens=shared + body,
            max_new_tokens=int(output_lens[i]),
            arrival_time=float(arrivals[i]),
        ))
    return reqs


def replay_trace(arrivals: Sequence[float], prompt_lens: Sequence[int],
                 output_lens: Sequence[int], *, vocab_size: int = 32000,
                 seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [
        Request(
            prompt_tokens=rng.integers(1, vocab_size, size=int(p)).tolist(),
            max_new_tokens=int(o),
            arrival_time=float(a),
        )
        for a, p, o in zip(arrivals, prompt_lens, output_lens)
    ]
