"""Hardware tiers for heterogeneous replica pools.

A *tier* is a hardware flavour a replica can run on — a chip name from
:mod:`repro.core.hardware` (``"h100"``, ``"a100"``, ``"l4"``, …) plus the
derived quantities the control plane needs to reason about mixed pools:

* ``cost_per_replica_s`` — $/replica-second (chip $/s × chips per replica),
  the unit :meth:`Cluster.replica_cost` and the benchmark cost metric accrue;
* ``throughput_factor`` — decode tokens/s on a canonical probe batch, used by
  tier-aware routing (``least_outstanding_tokens`` divides a replica's
  backlog by it, turning "fewest tokens" into "shortest drain time");
* ``projected_ttft_s`` — service-time estimate for a fresh request (one
  prefill step + one decode step), what the tier-selecting autoscaler checks
  against the TTFT SLO to pick the cheapest chip that can still answer fast
  enough.

All three are computed **from the tier's runtime predictor** — the same
object that sizes the emulator's virtual-time jumps and the DES baseline's
event durations — so the emulated cluster and the DES derive identical tier
arithmetic by construction (the §2.3 parity argument extended to
heterogeneous pools).  Probe maths are pure:

>>> from repro.core.predictor import StaticPredictor
>>> probe_throughput(StaticPredictor(0.01), batch=8)
800.0
>>> probe_ttft(StaticPredictor(0.01))
0.02

Invariant: a tier's :class:`TierSpec` is immutable and predictor-derived —
never edited per run — so any two components handed the same tier name and
predictors (Cluster, Autoscaler, DiscreteEventSimulator) agree on every
weight, cost, and feasibility decision.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Mapping, Optional, Sequence

from repro_torch.core.hardware import get_chip
from repro_torch.core.predictor import BatchSpec, RuntimePredictor, SeqSpec

__all__ = [
    "TierSpec",
    "probe_throughput",
    "probe_ttft",
    "tier_engine_cfg",
    "make_tier_spec",
    "make_tier_specs",
]

# Canonical probe shapes: a mid-size decode batch and a mid-size prompt.
# Arbitrary but *fixed* — every component must probe identically for the
# derived weights to agree across emulator and DES.
PROBE_DECODE_BATCH = 8
PROBE_CONTEXT = 256
PROBE_PROMPT = 256

# Fraction of (HBM − weights) given to the KV pool when sizing a tier's
# block count (the rest is activations / workspace).
KV_MEMORY_FRACTION = 0.9


@dataclass(frozen=True)
class TierSpec:
    """One hardware tier's control-plane summary (see module docstring)."""

    name: str                    # tier name as configured (alias allowed)
    chip: str                    # canonical chip name
    cost_per_replica_s: float    # $/replica-second (all chips of the replica)
    throughput_factor: float     # probe decode tokens/s (relative weight)
    projected_ttft_s: float      # prefill + first decode step on the probe


def probe_throughput(predictor: RuntimePredictor, *,
                     batch: int = PROBE_DECODE_BATCH,
                     context: int = PROBE_CONTEXT) -> float:
    """Decode tokens/s on the canonical probe batch (pure, deterministic).

    >>> from repro.core.predictor import StaticPredictor
    >>> probe_throughput(StaticPredictor(0.02), batch=4)
    200.0
    """
    spec = BatchSpec.make([SeqSpec(1, context)] * batch)
    step = predictor.predict_step(spec).total
    return batch / step


def probe_ttft(predictor: RuntimePredictor, *,
               prompt: int = PROBE_PROMPT) -> float:
    """Service-time TTFT estimate: one full prefill + one decode step.

    Queueing excluded on purpose: this is "how fast can this tier answer an
    unloaded request", the feasibility question tier selection asks.
    """
    prefill = predictor.predict_step(BatchSpec.make([SeqSpec(prompt, prompt)]))
    decode = predictor.predict_step(BatchSpec.make([SeqSpec(1, prompt + 1)]))
    return prefill.total + decode.total


def tier_engine_cfg(base, tier: str, model_cfg=None):
    """Clone an :class:`~repro.serving.scheduler.EngineConfig` onto a tier.

    Sets ``chip`` to the tier and, when ``model_cfg`` is given, re-derives
    the KV pool so capacity reflects the chip: the block count is capped at
    what fits in ``KV_MEMORY_FRACTION`` of the tier's HBM after weights
    (never *raised* above the base config — the base stays the configured
    ceiling, small chips shrink below it).  Raises if the model's weights
    alone exceed the tier's memory.
    """
    chip = get_chip(tier)
    cfg = replace(base, chip=tier)
    if model_cfg is None:
        return cfg
    n_dev = cfg.tp * cfg.pp
    weights = model_cfg.param_count() * model_cfg.dtype_bytes
    free = chip.hbm_capacity * n_dev - weights
    if free <= 0:
        raise ValueError(
            f"model weights ({weights / 1e9:.1f} GB) do not fit on tier "
            f"{tier!r} ({n_dev} × {chip.hbm_capacity / 1e9:.0f} GB)")
    budget = free * KV_MEMORY_FRACTION
    fit = int(budget // (cfg.block_size * model_cfg.kv_bytes_per_token()))
    return replace(cfg, num_blocks=max(1, min(base.num_blocks, fit)))


def make_tier_spec(tier: str, engine_cfg, *,
                   predictor: RuntimePredictor) -> TierSpec:
    """Build a tier's spec from its (tier-resolved) config and predictor."""
    chip = get_chip(tier)
    n_dev = engine_cfg.tp * engine_cfg.pp
    return TierSpec(
        name=tier,
        chip=chip.name,
        cost_per_replica_s=chip.cost_per_second * n_dev,
        throughput_factor=probe_throughput(predictor),
        projected_ttft_s=probe_ttft(predictor),
    )


def make_tier_specs(
    model_cfg,
    base_engine_cfg,
    tiers: Sequence[str],
    *,
    tier_predictors: Optional[Mapping[str, RuntimePredictor]] = None,
) -> Dict[str, TierSpec]:
    """Specs for a set of tiers, sharing one probe convention.

    ``tier_predictors`` overrides the per-tier predictor (benchmarks inject
    :class:`~repro.core.predictor.StaticPredictor` here); tiers without an
    entry get the default analytical predictor for their chip.  Build the
    dict **once** per experiment and hand the same mapping to
    :func:`~repro.cluster.cluster.build_cluster` and to
    :class:`~repro.des.simulator.DiscreteEventSimulator` so both sides share
    tier arithmetic exactly.
    """
    from repro_torch.serving.stack import default_predictor

    out: Dict[str, TierSpec] = {}
    for tier in dict.fromkeys(tiers):         # de-dup, order-preserving
        cfg = tier_engine_cfg(base_engine_cfg, tier, model_cfg)
        pred = (tier_predictors or {}).get(tier) \
            or default_predictor(model_cfg, cfg)
        out[tier] = make_tier_spec(tier, cfg, predictor=pred)
    return out
