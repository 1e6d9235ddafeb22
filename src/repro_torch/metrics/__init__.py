"""Bounded-memory metrics: quantile sketches, streaming moments, reservoirs.

The scale path replays millions of requests through one scenario; per-request
latency lists would dominate memory long before the emulator's own state
does.  This package keeps every summary the benchmark layer reports —
percentiles, means, SLO attainment, per-session stats — in O(1) (or
O(reservoir)) memory:

- :class:`QuantileSketch` — deterministic online percentile sketch
  (Greenwald–Khanna summary with an exact small-N mode), stdlib-only.
- :class:`StreamingStat` — count / sum / mean / min / max accumulator.
- :class:`ReservoirSample` — seeded Algorithm-R uniform sample.
- :class:`LatencyStats` — the summary dataclass the serving benchmark and
  scenario layers report (moved here from ``repro.serving.benchmark``,
  which re-exports it); raw-sample retention is opt-in.
- :class:`LatencyAccumulator` / :class:`StreamingMetrics` — streaming
  builders feeding the above from a completion stream (audit != "full").
"""

from .latency import (LatencyAccumulator, LatencyStats, StreamingMetrics,
                      compare_distributions)
from .sketch import QuantileSketch, ReservoirSample, StreamingStat

__all__ = [
    "QuantileSketch",
    "ReservoirSample",
    "StreamingStat",
    "LatencyStats",
    "LatencyAccumulator",
    "StreamingMetrics",
    "compare_distributions",
]
