"""Latency summaries on bounded memory.

:class:`LatencyStats` is the summary dataclass every benchmark/scenario
result carries (it lived in ``repro.serving.benchmark`` before the metrics
package existed; that module re-exports it).  Two construction paths:

- :meth:`LatencyStats.of` — from a materialized sample list (the audit=full
  path).  The headline fields (mean/p50/p90/p99) are computed with numpy
  exactly as before, so figure assertions and the parity bar are unmoved.
  Raw-sample retention is **opt-in** via ``keep_raw=True``; by default the
  result keeps only the summary plus an O(1)-memory sketch.
- :class:`LatencyAccumulator` — streaming construction, one ``add`` per
  completion, O(1) memory (audit=sampled/off).  Below the sketch's exact
  cap the percentiles are bit-identical to the materialized path.

:class:`StreamingMetrics` bundles the accumulators a full benchmark result
needs (TTFT/TPOT/e2e, SLO reservoir, per-session stats) behind one
``observe(request)`` call, shared by the emulator completion listener and
the DES sink.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from .sketch import QuantileSketch, ReservoirSample


@dataclass
class LatencyStats:
    """Latency distribution summary.

    ``values`` is raw-sample retention, **opt-in** (``of(..., keep_raw=True)``):
    a million-request run must not hold a million floats per metric.
    ``percentile`` answers arbitrary quantiles — exactly while raw values
    exist, within the sketch's ±eps rank error otherwise.
    """

    mean: float
    p50: float
    p90: float
    p99: float
    values: List[float] = field(repr=False, default_factory=list)
    count: int = 0
    maximum: float = 0.0
    sketch: Optional[QuantileSketch] = field(repr=False, compare=False,
                                             default=None)

    @staticmethod
    def of(values: Iterable[float],
           keep_raw: bool = False) -> "LatencyStats":
        vals = [float(v) for v in values]
        if not vals:
            return LatencyStats(0.0, 0.0, 0.0, 0.0, [])
        arr = np.asarray(vals, dtype=np.float64)
        sketch = QuantileSketch()
        sketch.extend(vals)
        return LatencyStats(
            float(arr.mean()),
            float(np.percentile(arr, 50)),
            float(np.percentile(arr, 90)),
            float(np.percentile(arr, 99)),
            vals if keep_raw else [],
            count=len(vals),
            maximum=float(arr.max()),
            sketch=sketch,
        )

    def percentile(self, q: float) -> float:
        """Quantile lookup: stored fields for 50/90/99, raw values when
        retained, sketch otherwise."""
        if self.count == 0 and not self.values:
            raise ValueError(
                "percentile of empty LatencyStats: no samples were recorded")
        for fixed_q, v in ((50, self.p50), (90, self.p90), (99, self.p99)):
            if q == fixed_q:
                return v
        if self.values:
            return float(np.percentile(
                np.asarray(self.values, dtype=np.float64), q))
        if self.sketch is not None and self.sketch.count:
            return self.sketch.percentile(q)
        raise ValueError(
            f"p{q} unavailable: stats carry neither raw values nor a sketch "
            f"(construct via LatencyStats.of or LatencyAccumulator)")


class LatencyAccumulator:
    """Streaming :class:`LatencyStats` builder: O(1) memory per metric."""

    def __init__(self, eps: float = 0.005, exact_cap: int = 2048):
        self.sketch = QuantileSketch(eps=eps, exact_cap=exact_cap)

    def add(self, value: float) -> None:
        self.sketch.add(value)

    @property
    def count(self) -> int:
        return self.sketch.count

    def stats(self) -> LatencyStats:
        sk = self.sketch
        if sk.count == 0:
            return LatencyStats(0.0, 0.0, 0.0, 0.0, [])
        return LatencyStats(
            mean=sk.mean,
            p50=sk.percentile(50),
            p90=sk.percentile(90),
            p99=sk.percentile(99),
            count=sk.count,
            maximum=sk.maximum,
            sketch=sk,
        )


def compare_distributions(a: LatencyStats, b: LatencyStats) -> Dict[str, float]:
    """Percentile-wise relative error between two latency distributions
    (the paper's Fig. 6/8 accuracy metric: <5% across the CDF).

    Works on raw-valued and sketch-backed stats alike; comparing a
    distribution with no samples is a usage bug and raises instead of
    silently reporting zero error.
    """
    for name, s in (("a", a), ("b", b)):
        if not s.values and not s.count:
            raise ValueError(
                f"compare_distributions: side {name!r} has no samples "
                f"(empty LatencyStats) — filter empty metrics before "
                f"comparing")
    out = {}
    for q in (50, 75, 90, 95, 99):
        va = a.percentile(q)
        vb = b.percentile(q)
        denom = max(abs(va), 1e-9)
        out[f"p{q}_rel_err"] = abs(va - vb) / denom
    out["median_rel_err"] = out["p50_rel_err"]
    return out


class _SessionAgg:
    """Per-live-session running sums; finalized into per-session means."""

    __slots__ = ("turns_seen", "ttft_sum", "ttft_n", "tpot_sum", "tpot_n")

    def __init__(self) -> None:
        self.turns_seen = 0
        self.ttft_sum = 0.0
        self.ttft_n = 0
        self.tpot_sum = 0.0
        self.tpot_n = 0


class StreamingMetrics:
    """One ``observe()`` per completed request; bounded memory throughout.

    Feeds TTFT/TPOT/e2e sketches, an exact completion/token count, the max
    finish time, a seeded reservoir of ``(ttft, tpot)`` SLO samples (with
    the exact sample count kept separately so goodput stays unbiased), and
    per-session mean TTFT/TPOT sketches.  Session state is held only for
    *live* sessions: when ``session_turns`` (a ``sid -> num_turns`` lookup)
    is provided, a session's running sums are folded into the sketches and
    dropped the moment its last turn completes, so memory tracks the number
    of concurrently-open sessions, not the total.  Thread-safe — emulator
    completion listeners fire from concurrent replica step threads.
    """

    def __init__(self, *, slo_reservoir: int = 8192, seed: int = 0,
                 session_turns: Optional[Callable[[int], int]] = None,
                 eps: float = 0.005, exact_cap: int = 2048):
        self._lock = threading.Lock()
        self.ttft = LatencyAccumulator(eps=eps, exact_cap=exact_cap)
        self.tpot = LatencyAccumulator(eps=eps, exact_cap=exact_cap)
        self.e2e = LatencyAccumulator(eps=eps, exact_cap=exact_cap)
        self.session_ttft = LatencyAccumulator(eps=eps, exact_cap=exact_cap)
        self.session_tpot = LatencyAccumulator(eps=eps, exact_cap=exact_cap)
        self.slo = ReservoirSample(slo_reservoir, seed=seed)
        self.count = 0
        self.total_new_tokens = 0
        self.max_finish: Optional[float] = None
        self.num_sessions = 0
        self._session_turns = session_turns
        self._sessions: Dict[int, _SessionAgg] = {}

    def observe(self, req) -> None:
        """``req`` needs ``ttft()``, ``tpot()``, ``num_generated``,
        ``finish_time``, ``arrival_time``, ``session_id``, ``turn_index`` —
        both the serving :class:`Request` and the DES ``SimRequest`` do."""
        ttft = req.ttft()
        tpot = req.tpot() if req.num_generated > 1 else None
        with self._lock:
            self.count += 1
            self.total_new_tokens += int(req.num_generated)
            if ttft is not None:
                self.ttft.add(ttft)
            if tpot is not None:
                self.tpot.add(tpot)
            if req.finish_time is not None:
                self.e2e.add(req.finish_time - req.arrival_time)
                if self.max_finish is None or req.finish_time > self.max_finish:
                    self.max_finish = req.finish_time
            self.slo.add((ttft, tpot))
            sid = req.session_id
            if sid is None:
                return
            agg = self._sessions.get(sid)
            if agg is None:
                agg = self._sessions[sid] = _SessionAgg()
            agg.turns_seen += 1
            if ttft is not None:
                agg.ttft_sum += ttft
                agg.ttft_n += 1
            if tpot is not None:
                agg.tpot_sum += tpot
                agg.tpot_n += 1
            if (self._session_turns is not None
                    and agg.turns_seen >= self._session_turns(sid)):
                self._finalize_session(sid)

    def _finalize_session(self, sid: int) -> None:
        agg = self._sessions.pop(sid)
        self.num_sessions += 1
        if agg.ttft_n:
            self.session_ttft.add(agg.ttft_sum / agg.ttft_n)
        if agg.tpot_n:
            self.session_tpot.add(agg.tpot_sum / agg.tpot_n)

    def finalize(self) -> None:
        """Fold any still-open sessions (run ended early, or no
        ``session_turns`` lookup was available) into the session sketches."""
        with self._lock:
            for sid in sorted(self._sessions):
                self._finalize_session(sid)

    @property
    def num_slo_samples(self) -> int:
        """Exact number of (ttft, tpot) observations — the reservoir holds a
        uniform subset, goodput scales attainment by this true count."""
        return self.slo.count
