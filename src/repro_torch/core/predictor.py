"""Runtime prediction (paper §4.4).

Revati's emulated workers ask "how long would this batch take on the target
hardware?" and jump virtual time by the answer.  The interface is pluggable;
three predictors are provided:

* :class:`AnalyticalPredictor` — the default, extending Vidur's operator-level
  decomposition with MoE routing, fused/paged attention variants, and ring
  collectives.  Per operator it computes FLOPs and HBM traffic, takes the
  roofline ``max(compute, memory)`` with calibratable efficiency ceilings,
  and adds collective and fixed dispatch overheads.  The same math feeds the
  §Roofline analysis, so predictor and dry-run agree by construction.
* :class:`TablePredictor` — profile-table lookup with bilinear interpolation
  over (prefill tokens, decode tokens, context); built by calibrating against
  real-mode execution (paper's "profiling-based" option).
* :class:`StaticPredictor` — fixed duration per step; used by the paper's
  Fig. 8/9 ablations ("static batch time predictions of varying durations").

All durations are seconds of *virtual* time.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

from .hardware import ChipSpec, TPU_V5E

__all__ = [
    "SeqSpec",
    "BatchSpec",
    "ParallelSpec",
    "StepEstimate",
    "RuntimePredictor",
    "StaticPredictor",
    "TablePredictor",
    "AnalyticalPredictor",
    "collective_time",
]


@dataclass(frozen=True)
class SeqSpec:
    """One sequence's contribution to a step.

    ``new_tokens``  — query tokens processed this step (prefill chunk size,
                      or 1 for decode).
    ``context_len`` — total KV length *after* this step (prompt so far +
                      generated), i.e. what attention reads against.
    ``cached_prefix`` — tokens served from prefix cache (skip compute, still
                      read KV).
    """

    new_tokens: int
    context_len: int
    cached_prefix: int = 0


@dataclass(frozen=True)
class BatchSpec:
    seqs: Tuple[SeqSpec, ...]

    @staticmethod
    def make(seqs: Sequence[SeqSpec]) -> "BatchSpec":
        return BatchSpec(tuple(seqs))

    @property
    def total_new_tokens(self) -> int:
        return sum(s.new_tokens for s in self.seqs)

    @property
    def num_prefill(self) -> int:
        return sum(1 for s in self.seqs if s.new_tokens > 1)

    @property
    def num_decode(self) -> int:
        return sum(1 for s in self.seqs if s.new_tokens == 1)

    @property
    def total_context(self) -> int:
        return sum(s.context_len for s in self.seqs)


@dataclass(frozen=True)
class ParallelSpec:
    tp: int = 1
    pp: int = 1
    ep: int = 1
    dp: int = 1

    @property
    def chips(self) -> int:
        return self.tp * self.pp * max(self.ep // self.tp, 1) * self.dp


@dataclass
class StepEstimate:
    total: float
    compute: float = 0.0
    memory: float = 0.0
    collective: float = 0.0
    overhead: float = 0.0
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class RuntimePredictor(Protocol):
    def predict_step(self, batch: BatchSpec) -> StepEstimate: ...


# --------------------------------------------------------------------------
class StaticPredictor:
    """Fixed step duration (paper Fig. 8/9: 5–40 ms static batch times)."""

    def __init__(self, duration_s: float):
        self.duration_s = float(duration_s)

    def predict_step(self, batch: BatchSpec) -> StepEstimate:
        return StepEstimate(total=self.duration_s, compute=self.duration_s)


# --------------------------------------------------------------------------
class TablePredictor:
    """Profile-table predictor with multilinear interpolation.

    Keyed on (prefill_tokens, decode_seqs, mean_context); built from
    real-mode measurements via :meth:`fit`.  Out-of-range queries clamp to
    the table edge (conservative for tails).
    """

    def __init__(self):
        self._samples: List[Tuple[Tuple[float, float, float], float]] = []

    @staticmethod
    def _key(batch: BatchSpec) -> Tuple[float, float, float]:
        prefill_tokens = sum(s.new_tokens for s in batch.seqs if s.new_tokens > 1)
        decode_seqs = batch.num_decode
        mean_ctx = batch.total_context / max(len(batch.seqs), 1)
        return (float(prefill_tokens), float(decode_seqs), float(mean_ctx))

    def fit(self, observations: Sequence[Tuple[BatchSpec, float]]) -> None:
        for batch, seconds in observations:
            self._samples.append((self._key(batch), float(seconds)))

    def add(self, batch: BatchSpec, seconds: float) -> None:
        self._samples.append((self._key(batch), float(seconds)))

    def predict_step(self, batch: BatchSpec) -> StepEstimate:
        if not self._samples:
            raise RuntimeError("TablePredictor has no samples; call fit() first")
        q = self._key(batch)
        # Inverse-distance weighting over the k nearest samples: robust for
        # the scattered grids produced by real profiling runs.
        scored = sorted(
            self._samples,
            key=lambda kv: sum((a - b) ** 2 for a, b in zip(kv[0], q)),
        )[:4]
        num = den = 0.0
        for key, val in scored:
            d2 = sum((a - b) ** 2 for a, b in zip(key, q))
            w = 1.0 / (d2 + 1e-9)
            num += w * val
            den += w
        t = num / den
        return StepEstimate(total=t, compute=t)


# --------------------------------------------------------------------------
class LinearPredictor:
    """Least-squares step-time model over batch-composition features.

    Vidur's operator-level decomposition is linear in the batch composition
    (projection FLOPs ∝ new tokens, attention reads ∝ context, dispatch is
    constant), so a regression on
    ``[1, prefill_tokens, decode_seqs, total_context]`` recovers the same
    structure directly from profiled steps — and, unlike a lookup table,
    extrapolates to batch shapes the calibration run never saw.
    """

    def __init__(self):
        self._coef = None

    @staticmethod
    def _features(batch: BatchSpec):
        prefill_tokens = sum(s.new_tokens for s in batch.seqs if s.new_tokens > 1)
        return [1.0, float(prefill_tokens), float(batch.num_decode),
                float(batch.total_context)]

    def fit(self, observations: Sequence[Tuple[BatchSpec, float]]) -> None:
        import numpy as np
        X = np.asarray([self._features(b) for b, _ in observations])
        y = np.asarray([t for _, t in observations])

        def solve(Xs, ys):
            try:
                # non-negative LS: every term has a physical cost, and
                # negative coefficients extrapolate pathologically outside
                # the calibrated envelope
                from scipy.optimize import nnls
                coef, _ = nnls(Xs, ys)
                return coef
            except ImportError:  # pragma: no cover
                coef, *_ = np.linalg.lstsq(Xs, ys, rcond=None)
                return coef

        self._coef = solve(X, y)
        # One trimmed refit: profiling on a shared CPU carries OS-scheduler
        # spikes (a preempted step measures several× its true cost); drop
        # points whose residual exceeds 3× the median absolute residual and
        # refit so a handful of spikes cannot bias every prediction.
        if len(y) >= 8:
            resid = np.abs(X @ self._coef - y)
            keep = resid <= 3.0 * max(float(np.median(resid)), 1e-9)
            if keep.sum() >= max(4, len(y) // 2) and keep.sum() < len(y):
                self._coef = solve(X[keep], y[keep])

    def predict_step(self, batch: BatchSpec) -> StepEstimate:
        if self._coef is None:
            raise RuntimeError("LinearPredictor has no fit; call fit() first")
        t = float(sum(c * f for c, f in zip(self._coef, self._features(batch))))
        t = max(t, 1e-6)   # physical floor: a step is never free
        return StepEstimate(total=t, compute=t)


# --------------------------------------------------------------------------
def collective_time(
    nbytes: float,
    group: int,
    chip: ChipSpec,
    kind: str = "all_reduce",
    links: Optional[int] = None,
) -> float:
    """Ring-collective cost model on the ICI torus.

    all_reduce:      2·(n−1)/n · B / bw      (reduce-scatter + all-gather)
    all_gather /
    reduce_scatter:  (n−1)/n · B / bw
    all_to_all:      (n−1)/n · B / bw        (balanced personalized exchange)
    p2p:             B / bw
    """
    if group <= 1 or nbytes <= 0:
        return 0.0
    bw = chip.interconnect_bandwidth * (links or 1) * chip.collective_efficiency
    frac = (group - 1) / group
    factor = {"all_reduce": 2 * frac, "all_gather": frac,
              "reduce_scatter": frac, "all_to_all": frac, "p2p": 1.0}[kind]
    return factor * nbytes / bw


class AnalyticalPredictor:
    """Operator-level analytical model (Vidur-extended) for one engine step.

    Decomposition per transformer block: QKV proj, attention (fused
    flash/paged), output proj, MLP or MoE (router + experts + all-to-all),
    norms; plus embedding/unembedding and TP all-reduces.  Each dense op is
    ``max(flops / (peak·eff_mm), bytes / (bw·eff_hbm))``; memory-bound decode
    and compute-bound prefill both fall out of the same formulas.

    ``overlap_collectives``: when True (beyond-paper optimization, see
    EXPERIMENTS.md §Perf), TP collectives are assumed overlapped with compute
    and only their non-hidden remainder is charged.
    """

    def __init__(
        self,
        model,                      # repro.models.config.ModelConfig
        parallel: ParallelSpec = ParallelSpec(),
        chip: ChipSpec = TPU_V5E,
        *,
        step_overhead_s: float = 50e-6,     # dispatch / host sync per step
        layer_overhead_s: float = 3e-6,     # per-layer launch equivalent
        overlap_collectives: bool = False,
    ):
        self.model = model
        self.parallel = parallel
        self.chip = chip
        self.step_overhead_s = step_overhead_s
        self.layer_overhead_s = layer_overhead_s
        self.overlap_collectives = overlap_collectives

    # ------------------------------------------------------------ helpers --
    def _dense_op(self, flops: float, bytes_: float) -> Tuple[float, float, float]:
        c = flops / (self.chip.peak_flops_bf16 * self.chip.matmul_efficiency)
        m = bytes_ / (self.chip.hbm_bandwidth * self.chip.hbm_efficiency)
        return max(c, m), c, m

    # ------------------------------------------------------------ predict --
    def predict_step(self, batch: BatchSpec) -> StepEstimate:
        cfg = self.model
        par = self.parallel
        chip = self.chip
        B = cfg.dtype_bytes
        tp = par.tp
        T = batch.total_new_tokens
        if T == 0:
            return StepEstimate(total=self.step_overhead_s, overhead=self.step_overhead_s)

        est = StepEstimate(total=0.0)
        time_s = 0.0

        # --- per-kind block costs, multiplied by pattern counts ------------
        kind_counts: Dict[str, int] = {}
        for k in cfg.layer_pattern:
            kind_counts[k] = kind_counts.get(k, 0) + 1

        for kind, count in kind_counts.items():
            t_block, blk = self._block_cost(kind, batch, B, tp)
            time_s += count * t_block
            est.compute += count * blk["c"]
            est.memory += count * blk["m"]
            est.collective += count * blk["coll"]
            est.flops += count * blk["flops"]
            est.hbm_bytes += count * blk["bytes"]
            est.collective_bytes += count * blk["coll_bytes"]

        # --- encoder tower (enc-dec): encoder runs once per prefill -------
        if cfg.is_enc_dec and batch.num_prefill > 0:
            enc_tokens = cfg.encoder.max_source_positions * batch.num_prefill
            enc_batch = BatchSpec.make(
                [SeqSpec(cfg.encoder.max_source_positions,
                         cfg.encoder.max_source_positions)] * batch.num_prefill
            )
            t_block, blk = self._block_cost("attn", enc_batch, B, tp, causal=False)
            time_s += cfg.encoder.num_layers * t_block
            est.compute += cfg.encoder.num_layers * blk["c"]
            est.memory += cfg.encoder.num_layers * blk["m"]
            est.flops += cfg.encoder.num_layers * blk["flops"]
            est.hbm_bytes += cfg.encoder.num_layers * blk["bytes"]

        # --- unembedding (logits) ------------------------------------------
        logit_flops = 2.0 * T * cfg.d_model * cfg.vocab_size / tp
        logit_bytes = (cfg.d_model * cfg.vocab_size * B) / tp + T * cfg.vocab_size * B / tp
        t_op, c, m = self._dense_op(logit_flops, logit_bytes)
        time_s += t_op
        est.compute += c
        est.memory += m
        est.flops += logit_flops
        est.hbm_bytes += logit_bytes

        # --- pipeline parallel: per-stage time + inter-stage p2p -----------
        if par.pp > 1:
            # Serving PP runs one microbatch per step per stage; steady-state
            # step latency is stage time + (pp-1) hops of activation p2p.
            act_bytes = T * cfg.d_model * B
            hop = collective_time(act_bytes, 2, chip, "p2p")
            time_s = time_s / par.pp + (par.pp - 1) * hop
            est.collective += (par.pp - 1) * hop
            est.collective_bytes += (par.pp - 1) * act_bytes

        overhead = self.step_overhead_s + cfg.num_layers * self.layer_overhead_s / max(par.pp, 1)
        est.overhead = overhead
        est.total = time_s + overhead
        return est

    # ----------------------------------------------------------- internals --
    def _block_cost(
        self, kind: str, batch: BatchSpec, B: int, tp: int, *, causal: bool = True
    ) -> Tuple[float, Dict[str, float]]:
        cfg = self.model
        chip = self.chip
        T = batch.total_new_tokens
        flops = 0.0
        bytes_ = 0.0
        coll_bytes = 0.0
        comp_t = mem_t = coll_t = 0.0
        time_s = 0.0

        def add_op(f: float, by: float) -> None:
            nonlocal time_s, comp_t, mem_t, flops, bytes_
            t, c, m = self._dense_op(f, by)
            time_s += t
            comp_t += c
            mem_t += m
            flops += f
            bytes_ += by

        if kind in ("attn", "local_attn"):
            # -- projections (TP-sharded) --
            qkv_w = cfg.d_model * (cfg.q_size + 2 * cfg.kv_size)
            add_op(2.0 * T * qkv_w / tp, (qkv_w * B) / tp + 2 * T * cfg.d_model * B)
            # -- attention (fused flash/paged; window-capped context) --
            window = cfg.sliding_window if (kind == "local_attn" or cfg.sliding_window) else None
            attn_flops = 0.0
            kv_read = 0.0
            for s in batch.seqs:
                ctx = s.context_len if window is None else min(s.context_len, window)
                # causal: mean context over the chunk's query positions
                eff_ctx = ctx - (s.new_tokens - 1) / 2.0 if causal else ctx
                eff_ctx = max(eff_ctx, 1.0)
                attn_flops += 4.0 * s.new_tokens * eff_ctx * cfg.num_heads * cfg.head_dim
                kv_read += ctx * 2 * cfg.kv_size * B
            add_op(attn_flops / tp, kv_read / tp + T * 2 * cfg.kv_size * B / tp)
            # -- output proj --
            out_w = cfg.q_size * cfg.d_model
            add_op(2.0 * T * out_w / tp, out_w * B / tp + T * cfg.d_model * B)
            # -- MLP or MoE --
            n_mats = 3 if cfg.mlp_act == "swiglu" else 2
            if cfg.moe is None:
                mlp_w = n_mats * cfg.d_model * cfg.d_ff
                add_op(2.0 * T * mlp_w / tp, mlp_w * B / tp + 2 * T * cfg.d_model * B)
            else:
                moe = cfg.moe
                ep = max(self.parallel.ep, 1)
                add_op(2.0 * T * cfg.d_model * moe.num_experts,
                       cfg.d_model * moe.num_experts * B)  # router
                expert_w = n_mats * cfg.d_model * moe.d_ff_expert
                expert_tokens = T * moe.top_k
                # Experts sharded EP-ways: weights/ep resident per chip; each
                # chip computes its share of routed tokens.
                add_op(2.0 * expert_tokens * expert_w / max(tp, ep),
                       moe.num_experts * expert_w * B / max(tp, ep)
                       + 2 * expert_tokens * cfg.d_model * B / max(tp, ep))
                if ep > 1:
                    a2a = 2 * expert_tokens * cfg.d_model * B  # dispatch+combine
                    t = collective_time(a2a, ep, chip, "all_to_all")
                    time_s += t
                    coll_t += t
                    coll_bytes += a2a
            # -- TP all-reduces (attn out + mlp out) --
            if tp > 1:
                ar_bytes = 2 * T * cfg.d_model * B
                t = collective_time(ar_bytes, tp, chip, "all_reduce")
                if self.overlap_collectives:
                    t = max(0.0, t - 0.5 * time_s)  # hidden under compute
                time_s += t
                coll_t += t
                coll_bytes += ar_bytes
            # -- cross-attention for enc-dec decoder --
            if cfg.is_enc_dec and causal:
                xw = cfg.d_model * (cfg.q_size + 2 * cfg.kv_size) + cfg.q_size * cfg.d_model
                add_op(2.0 * T * xw / tp, xw * B / tp)
                x_flops = sum(
                    4.0 * s.new_tokens * cfg.encoder.max_source_positions
                    * cfg.num_heads * cfg.head_dim
                    for s in batch.seqs
                )
                x_read = len(batch.seqs) * cfg.encoder.max_source_positions * 2 * cfg.kv_size * B
                add_op(x_flops / tp, x_read / tp)

        elif kind == "ssd":
            ssm = cfg.ssm
            d_in = ssm.d_inner(cfg.d_model)
            nheads = ssm.num_heads(cfg.d_model)
            w_in = cfg.d_model * (2 * d_in + 2 * ssm.state_dim + nheads)
            add_op(2.0 * T * w_in / tp, w_in * B / tp + T * cfg.d_model * B)
            # SSD state update/scan: decode reads+writes the full state.
            state_bytes = nheads * ssm.head_dim * ssm.state_dim * 4
            scan_flops = 0.0
            state_traffic = 0.0
            for s in batch.seqs:
                if s.new_tokens == 1:
                    scan_flops += 2.0 * nheads * ssm.head_dim * ssm.state_dim * 2
                    state_traffic += 2 * state_bytes
                else:
                    L = s.new_tokens
                    c = ssm.chunk_size
                    # intra-chunk quadratic + inter-chunk recurrence
                    scan_flops += 4.0 * L * c * nheads * ssm.head_dim
                    scan_flops += 4.0 * L * nheads * ssm.head_dim * ssm.state_dim
                    state_traffic += 2 * state_bytes * max(L // c, 1)
            add_op(scan_flops / tp, state_traffic / tp)
            w_out = d_in * cfg.d_model
            add_op(2.0 * T * w_out / tp, w_out * B / tp + T * cfg.d_model * B)
            if tp > 1:
                ar_bytes = T * cfg.d_model * B
                t = collective_time(ar_bytes, tp, chip, "all_reduce")
                time_s += t
                coll_bytes += ar_bytes

        elif kind == "rglru":
            rg = cfg.rglru
            w = rg.lru_width
            w_total = 2 * cfg.d_model * w + w * cfg.d_model + 2 * w * w
            add_op(2.0 * T * w_total / tp, w_total * B / tp + 2 * T * cfg.d_model * B)
            # element-wise recurrence: state read/write per token
            state_traffic = sum(2 * w * 4 * s.new_tokens for s in batch.seqs)
            add_op(6.0 * T * w, state_traffic / tp)
            n_mats = 3 if cfg.mlp_act == "swiglu" else 2
            mlp_w = n_mats * cfg.d_model * cfg.d_ff
            add_op(2.0 * T * mlp_w / tp, mlp_w * B / tp + 2 * T * cfg.d_model * B)
            if tp > 1:
                ar_bytes = 2 * T * cfg.d_model * B
                t = collective_time(ar_bytes, tp, chip, "all_reduce")
                time_s += t
                coll_t += t
                coll_bytes += ar_bytes

        else:  # pragma: no cover
            raise ValueError(f"unknown block kind {kind!r}")

        blk = {
            "c": comp_t,
            "m": mem_t,
            "coll": coll_t,
            "flops": flops,
            "bytes": bytes_,
            "coll_bytes": coll_bytes,
        }
        return time_s, blk
