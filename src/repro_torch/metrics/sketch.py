"""Deterministic O(1)-memory accumulators (stdlib-only).

:class:`QuantileSketch` is a Greenwald–Khanna (GK) quantile summary with an
exact small-N front end: below ``exact_cap`` samples it simply keeps the
values and answers percentiles with the same linear interpolation
``np.percentile`` uses (bit-for-bit — the small-N figure assertions and the
scenario parity bar must not move when results become sketch-backed).  Past
the cap it spills into a GK summary whose size is O(1/eps · log(eps·n)) and
whose answers carry a ±eps·n rank-error guarantee.

Everything here is deterministic: same insertion order ⇒ same internal state
⇒ same answers, with no wall-clock or global-RNG dependence.  The reservoir
uses its own seeded ``random.Random``.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Any, Iterable, List, Optional


def _np_lerp(a: float, b: float, t: float) -> float:
    """numpy's linear-interpolation kernel (bit-exact with np.percentile)."""
    diff = b - a
    if t >= 0.5:
        return b - diff * (1.0 - t)
    return a + diff * t


def _interpolate(sorted_vals: List[float], frac: float) -> float:
    """Value at cumulative fraction ``frac`` of a sorted sample, matching
    ``np.percentile(..., method="linear")`` exactly."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = frac * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    return _np_lerp(sorted_vals[lo], sorted_vals[hi], pos - lo)


class QuantileSketch:
    """Online percentile sketch: exact below ``exact_cap``, GK beyond.

    GK invariant: for every summary entry ``(v, g, delta)``,
    ``g + delta <= floor(2 * eps * n)``, which bounds the rank uncertainty
    of any answer by ``eps * n``.  Inserts are buffered and applied as
    sorted batches (one O(entries + batch) merge per ``~1/(2 eps)`` adds),
    so amortized insert cost stays flat.
    """

    def __init__(self, eps: float = 0.005, exact_cap: int = 2048):
        if not 0.0 < eps < 0.5:
            raise ValueError(f"eps must be in (0, 0.5), got {eps}")
        self.eps = float(eps)
        self.exact_cap = int(exact_cap)
        self.count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._exact: Optional[List[float]] = []      # None once in GK mode
        self._entries: List[List[float]] = []        # [v, g, delta], v-sorted
        self._buffer: List[float] = []
        self._buffer_cap = max(16, int(1.0 / (2.0 * self.eps)))

    # ------------------------------------------------------------- insert --
    def add(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if self._exact is not None:
            self._exact.append(v)
            if len(self._exact) > self.exact_cap:
                self._spill()
            return
        self._buffer.append(v)
        if len(self._buffer) >= self._buffer_cap:
            self._flush()

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(v)

    def _spill(self) -> None:
        vals = sorted(self._exact)
        self._exact = None
        self._entries = [[v, 1, 0] for v in vals]
        self._compress()

    def _flush(self) -> None:
        if not self._buffer:
            return
        buf = sorted(self._buffer)
        self._buffer = []
        # GK insert rule: an interior insert may claim delta = floor(2εn)-1;
        # inserts at either extreme are exact (delta = 0).
        dmax = max(0, int(math.floor(2.0 * self.eps * self.count)) - 1)
        entries = self._entries
        out: List[List[float]] = []
        i = 0
        for v in buf:
            while i < len(entries) and entries[i][0] <= v:
                out.append(entries[i])
                i += 1
            delta = 0 if (i == 0 or i == len(entries)) else dmax
            out.append([v, 1, delta])
        out.extend(entries[i:])
        self._entries = out
        self._compress()

    def _compress(self) -> None:
        entries = self._entries
        if len(entries) < 3:
            return
        threshold = int(math.floor(2.0 * self.eps * self.count))
        out = [entries[-1]]
        # right-to-left greedy merge of an entry into its successor; the
        # first and last entries are never merged away (min/max stay exact)
        for i in range(len(entries) - 2, 0, -1):
            e = entries[i]
            succ = out[-1]
            if e[1] + succ[1] + succ[2] <= threshold:
                succ[1] += e[1]
            else:
                out.append(e)
        out.append(entries[0])
        out.reverse()
        self._entries = out

    # -------------------------------------------------------------- query --
    def quantile(self, frac: float) -> float:
        """Value at cumulative fraction ``frac`` in [0, 1]."""
        if self.count == 0:
            raise ValueError("quantile of an empty QuantileSketch")
        if self._exact is not None:
            return _interpolate(sorted(self._exact), frac)
        self._flush()
        n = self.count
        rank = 1.0 + frac * (n - 1)              # fractional 1-based rank
        margin = self.eps * n
        cum = 0
        prev = self._entries[0][0]
        for v, g, d in self._entries:
            cum += g
            if cum + d > rank + margin:
                return prev
            prev = v
        return self._entries[-1][0]

    def percentile(self, q: float) -> float:
        return self.quantile(q / 100.0)

    @property
    def mean(self) -> float:
        return self._sum / self.count if self.count else 0.0

    @property
    def minimum(self) -> float:
        return self._min

    @property
    def maximum(self) -> float:
        return self._max

    @property
    def num_entries(self) -> int:
        """Current summary footprint (exact buffer or GK entry count)."""
        if self._exact is not None:
            return len(self._exact)
        return len(self._entries) + len(self._buffer)

    # -------------------------------------------------------------- merge --
    def _gk_entries(self) -> List[List[float]]:
        if self._exact is not None:
            return [[v, 1, 0] for v in sorted(self._exact)]
        self._flush()
        return [list(e) for e in self._entries]

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Combine two sketches into a new one.

        Merging keeps each input's ``(g, delta)`` bookkeeping, so the result
        carries the *sum* of the inputs' rank errors (standard GK merge
        behavior) — still bounded, just looser than a single-stream sketch.
        """
        out = QuantileSketch(eps=max(self.eps, other.eps),
                             exact_cap=self.exact_cap)
        out.count = self.count + other.count
        out._sum = self._sum + other._sum
        out._min = min(self._min, other._min)
        out._max = max(self._max, other._max)
        if (self._exact is not None and other._exact is not None
                and out.count <= out.exact_cap):
            out._exact = sorted(self._exact + other._exact)
            return out
        a, b = self._gk_entries(), other._gk_entries()
        merged: List[List[float]] = []
        i = j = 0
        while i < len(a) and j < len(b):
            if a[i][0] <= b[j][0]:
                merged.append(a[i])
                i += 1
            else:
                merged.append(b[j])
                j += 1
        merged.extend(a[i:])
        merged.extend(b[j:])
        out._exact = None
        out._entries = merged
        out._compress()
        return out

    # -------------------------------------------------------------- state --
    def state(self) -> dict:
        """Canonical serializable state (the byte-stability contract)."""
        if self._exact is not None:
            body: dict = {"exact": list(self._exact)}
        else:
            self._flush()
            body = {"entries": [list(e) for e in self._entries]}
        return {"eps": self.eps, "count": self.count, "sum": self._sum,
                "min": self._min, "max": self._max, **body}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        mode = "exact" if self._exact is not None else "gk"
        return (f"QuantileSketch(eps={self.eps}, n={self.count}, "
                f"mode={mode}, entries={self.num_entries})")


@dataclass
class StreamingStat:
    """Count / sum / mean / min / max in O(1) memory."""

    count: int = 0
    total: float = 0.0
    minimum: float = math.inf
    maximum: float = -math.inf

    def add(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.minimum:
            self.minimum = v
        if v > self.maximum:
            self.maximum = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class ReservoirSample:
    """Seeded Algorithm-R uniform reservoir: deterministic under a fixed
    seed and insertion order, O(capacity) memory for any stream length."""

    def __init__(self, capacity: int, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.count = 0
        self.items: List[Any] = []
        self._rng = random.Random(seed)

    def add(self, item: Any) -> None:
        self.count += 1
        if len(self.items) < self.capacity:
            self.items.append(item)
            return
        j = self._rng.randrange(self.count)
        if j < self.capacity:
            self.items[j] = item

    @property
    def exact(self) -> bool:
        """True while the reservoir still holds every observed item."""
        return self.count <= self.capacity

    def __len__(self) -> int:
        return len(self.items)
