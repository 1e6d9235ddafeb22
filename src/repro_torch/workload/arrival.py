"""Pluggable arrival processes: when requests (or sessions) hit the cluster.

The paper's sweep story needs more than a single Poisson knob: real serving
traffic is bursty (overdispersed inter-arrivals), spiky (on/off phases from
upstream batch jobs), and diurnal (rate follows a daily curve).  Each process
here turns ``(n, rng)`` into a sorted array of arrival times with the first
request at ``t=0`` — the stream is *shifted*, never clipped, so the generated
inter-arrival gaps all survive (clobbering the first gap biases effective QPS
for small n; see tests/test_workload.py for the regression).

All processes are seeded through the caller's ``numpy`` Generator, so request
streams stay byte-identical across real/sleep/emulate/DES runs.

Invariants every process guarantees (property-tested in
tests/test_workload.py):

* ``sample(n, rng)`` returns exactly ``n`` non-decreasing times;
* renewal processes (poisson/gamma/onoff) place the first arrival at t=0 by
  *shifting*; trace replay keeps absolute phase instead (see
  :class:`RateTraceArrivals`);
* ``mean_rate()`` equals the configured long-run rate regardless of the
  burstiness knobs, so a burstiness sweep holds offered load constant;
* ``iter_times(rng)`` is the streaming form: an endless generator whose
  first ``n`` values are byte-identical to ``sample(n, rng)`` for every
  ``n`` — random draws happen in bounded chunks, so a million-arrival
  stream never materializes an array of a million gaps.

>>> import numpy as np
>>> from itertools import islice
>>> p = PoissonArrivals(qps=2.0)
>>> lazy = list(islice(p.iter_times(np.random.default_rng(0)), 5))
>>> lazy == p.sample(5, np.random.default_rng(0)).tolist()
True

>>> import numpy as np
>>> times = PoissonArrivals(qps=2.0).sample(5, np.random.default_rng(0))
>>> len(times), float(times[0]), bool(np.all(np.diff(times) >= 0))
(5, 0.0, True)
>>> GammaArrivals(qps=2.0, cv2=8.0).mean_rate()   # burstiness != load
2.0
>>> make_arrival("onoff", 4.0, period_s=5.0, duty=0.5).name
'onoff'
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ArrivalProcess",
    "UniformArrivals",
    "PoissonArrivals",
    "GammaArrivals",
    "OnOffArrivals",
    "RateTraceArrivals",
    "ARRIVAL_PROCESSES",
    "make_arrival",
]


def _shift_to_zero(times: np.ndarray) -> np.ndarray:
    """First arrival at t=0 by shifting the whole stream (gap-preserving)."""
    if times.size == 0:
        return times
    return times - times[0]


class ArrivalProcess:
    """Base: ``sample(n, rng)`` returns n sorted arrival times, first at 0."""

    name = "?"

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def iter_times(self, rng: np.random.Generator, chunk: int = 256):
        """Endless generator of arrival times, byte-identical to ``sample``.

        Draws from ``rng`` in ``chunk``-sized batches (numpy Generators fill
        arrays sequentially, so chunked draws reproduce one big draw), so
        look-ahead memory is O(chunk) no matter how far the stream runs.
        """
        raise NotImplementedError

    def mean_rate(self) -> float:
        """Long-run average arrivals/second (used by sizing heuristics)."""
        raise NotImplementedError


class UniformArrivals(ArrivalProcess):
    """Deterministically spaced arrivals: request ``i`` at ``i / qps``.

    No randomness at all — the process draws nothing from ``rng``.  This is
    the arrival shape backend-parity scenarios use: every request lands on an
    idle replica with headroom, so service starts continuously and a few ms
    of cross-backend wall-rate absorption cannot flip a step-boundary
    admission (see ``benchmarks/fig_distributed.py``).

    >>> import numpy as np
    >>> UniformArrivals(qps=4.0).sample(3, np.random.default_rng(0)).tolist()
    [0.0, 0.25, 0.5]
    """

    name = "uniform"

    def __init__(self, qps: float):
        assert qps > 0
        self.qps = qps

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        return np.arange(n, dtype=np.float64) / self.qps

    def iter_times(self, rng: np.random.Generator, chunk: int = 256):
        i = 0
        while True:
            yield float(np.float64(i) / self.qps)
            i += 1

    def mean_rate(self) -> float:
        return self.qps


class PoissonArrivals(ArrivalProcess):
    """Memoryless baseline: exponential gaps at ``qps``."""

    name = "poisson"

    def __init__(self, qps: float):
        assert qps > 0
        self.qps = qps

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        gaps = rng.exponential(1.0 / self.qps, size=n)
        return _shift_to_zero(np.cumsum(gaps))

    def iter_times(self, rng: np.random.Generator, chunk: int = 256):
        t = 0.0
        first = None
        while True:
            for g in rng.exponential(1.0 / self.qps, size=chunk):
                t += g
                if first is None:
                    first = t
                yield t - first

    def mean_rate(self) -> float:
        return self.qps


class GammaArrivals(ArrivalProcess):
    """Bursty renewal process: gamma gaps with squared coefficient of
    variation ``cv2`` (cv2=1 degenerates to Poisson; cv2≫1 clusters arrivals
    into bursts separated by long lulls — the overdispersion measured in
    production LLM traces).  Mean rate stays ``qps`` regardless of cv2, so a
    burstiness sweep holds offered load constant."""

    name = "gamma"

    def __init__(self, qps: float, cv2: float = 4.0):
        assert qps > 0 and cv2 > 0
        self.qps = qps
        self.cv2 = cv2

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        shape = 1.0 / self.cv2
        scale = self.cv2 / self.qps          # shape*scale = 1/qps
        gaps = rng.gamma(shape, scale, size=n)
        return _shift_to_zero(np.cumsum(gaps))

    def iter_times(self, rng: np.random.Generator, chunk: int = 256):
        shape = 1.0 / self.cv2
        scale = self.cv2 / self.qps
        t = 0.0
        first = None
        while True:
            for g in rng.gamma(shape, scale, size=chunk):
                t += g
                if first is None:
                    first = t
                yield t - first

    def mean_rate(self) -> float:
        return self.qps


class OnOffArrivals(ArrivalProcess):
    """Square-wave spikes: Poisson bursts at ``qps/duty`` during the ON
    fraction of each period, silence otherwise (average rate stays ``qps``).
    Models upstream batch jobs / retry storms hammering the cluster in
    phases."""

    name = "onoff"

    def __init__(self, qps: float, period_s: float = 10.0, duty: float = 0.25):
        assert qps > 0 and period_s > 0 and 0 < duty <= 1
        self.qps = qps
        self.period_s = period_s
        self.duty = duty

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        on_len = self.period_s * self.duty
        off_len = self.period_s - on_len
        gaps = rng.exponential(self.duty / self.qps, size=n)  # ON-phase rate
        times = np.empty(n, dtype=np.float64)
        t = 0.0                              # position within ON time only
        for i, g in enumerate(gaps):
            t += g
            # map accumulated ON-time onto the wall: insert an OFF gap at
            # every period boundary crossed
            periods = int(t // on_len)
            times[i] = t + periods * off_len
        return _shift_to_zero(times)

    def iter_times(self, rng: np.random.Generator, chunk: int = 256):
        on_len = self.period_s * self.duty
        off_len = self.period_s - on_len
        t = 0.0
        first = None
        while True:
            for g in rng.exponential(self.duty / self.qps, size=chunk):
                t += g
                periods = int(t // on_len)
                cur = t + periods * off_len
                if first is None:
                    first = cur
                yield cur - first

    def mean_rate(self) -> float:
        return self.qps


class RateTraceArrivals(ArrivalProcess):
    """Piecewise-constant rate-trace replay (diurnal curves, recorded load).

    ``trace`` is a sequence of ``(duration_s, qps)`` segments, repeated
    cyclically for as long as needed.  Arrivals are drawn by time-rescaling:
    unit-exponential increments are mapped through the inverse cumulative
    rate, the standard inhomogeneous-Poisson construction.  ``scale_to_qps``
    rescales the whole trace so its long-run mean matches a target rate —
    handy for sweeping load while keeping the *shape* of the day.

    Unlike the renewal processes, trace replay is **not** shifted to t=0:
    arrival times keep their absolute phase against the trace (a quiet
    leading segment yields a late first arrival), because the whole point of
    replay is that load aligns with the recorded curve."""

    name = "trace"

    def __init__(self, trace: Sequence[Tuple[float, float]],
                 scale_to_qps: Optional[float] = None):
        assert trace, "rate trace needs at least one (duration, qps) segment"
        durs = np.asarray([d for d, _ in trace], dtype=np.float64)
        rates = np.asarray([r for _, r in trace], dtype=np.float64)
        assert (durs > 0).all() and (rates >= 0).all() and rates.sum() > 0
        if scale_to_qps is not None:
            mean = float((durs * rates).sum() / durs.sum())
            rates = rates * (scale_to_qps / mean)
        self.durations = durs
        self.rates = rates

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        increments = rng.exponential(1.0, size=n)   # unit-rate Poisson
        targets = np.cumsum(increments)             # cumulative expected count
        times = np.empty(n, dtype=np.float64)
        seg, t0, mass = 0, 0.0, 0.0                 # mass = integral of rate
        nseg = len(self.durations)
        for i, target in enumerate(targets):
            while True:
                d, r = self.durations[seg % nseg], self.rates[seg % nseg]
                seg_mass = d * r
                if mass + seg_mass >= target and r > 0:
                    times[i] = t0 + (target - mass) / r
                    break
                mass += seg_mass
                t0 += d
                seg += 1
        return times                     # phase-aligned: no shift

    def iter_times(self, rng: np.random.Generator, chunk: int = 256):
        seg, t0, mass = 0, 0.0, 0.0
        target = 0.0
        nseg = len(self.durations)
        while True:
            for inc in rng.exponential(1.0, size=chunk):
                target += inc
                while True:
                    d = self.durations[seg % nseg]
                    r = self.rates[seg % nseg]
                    seg_mass = d * r
                    if mass + seg_mass >= target and r > 0:
                        yield float(t0 + (target - mass) / r)
                        break
                    mass += seg_mass
                    t0 += d
                    seg += 1

    def mean_rate(self) -> float:
        return float((self.durations * self.rates).sum()
                     / self.durations.sum())


ARRIVAL_PROCESSES = {
    cls.name: cls
    for cls in (UniformArrivals, PoissonArrivals, GammaArrivals,
                OnOffArrivals, RateTraceArrivals)
}


def make_arrival(name: str, qps: float, **kwargs) -> ArrivalProcess:
    try:
        cls = ARRIVAL_PROCESSES[name]
    except KeyError:
        raise ValueError(
            f"unknown arrival process {name!r}; "
            f"choose from {sorted(ARRIVAL_PROCESSES)}") from None
    if cls is RateTraceArrivals:
        # the trace fixes absolute rates; qps becomes the rescale target
        kwargs.setdefault("scale_to_qps", qps)
        return cls(**kwargs)
    return cls(qps, **kwargs)
