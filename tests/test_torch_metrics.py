"""The port's metrics (``repro_torch.metrics``), with the reference's tests
(``tests/test_metrics.py``) held against the port's copy.  O(1)-memory metrics: GK sketch guarantees, reservoir determinism, and the
LatencyStats exact/sketch-backed contract.

The streaming scale path (``audit="sampled"``) replaces retained per-request
lists with these accumulators, so the properties under test here — exact
small-N equivalence with numpy, the ±eps·n rank-error bound past the cap,
deterministic serialized state — are what keep million-session results
trustworthy and reproducible."""

from __future__ import annotations

import json

import numpy as np
import pytest

from repro_torch.metrics import (LatencyAccumulator, LatencyStats,
                                 QuantileSketch, ReservoirSample, StreamingStat,
                                 compare_distributions)

import torch

torch.set_num_threads(2)    # the suite runs in several workers at once

QS = (1.0, 5.0, 25.0, 50.0, 75.0, 90.0, 95.0, 99.0)


def _rank_err(sorted_vals: np.ndarray, answer: float, q: float) -> float:
    """Absolute rank distance between the sketch's answer and the target."""
    target = (q / 100.0) * (len(sorted_vals) - 1)
    lo = np.searchsorted(sorted_vals, answer, side="left")
    hi = np.searchsorted(sorted_vals, answer, side="right")
    # the answer occupies a rank interval when duplicated; take the closest
    if lo <= target <= hi:
        return 0.0
    return float(min(abs(lo - target), abs(hi - target)))


# ---------------------------------------------------------------- exact mode

def test_exact_small_n_is_bit_identical_to_numpy():
    rng = np.random.default_rng(7)
    vals = rng.lognormal(0.0, 1.0, size=500)      # below exact_cap
    sk = QuantileSketch()
    sk.extend(vals)
    for q in QS:
        assert sk.percentile(q) == float(np.percentile(vals, q))
    assert sk.mean == pytest.approx(float(vals.mean()))
    assert sk.maximum == float(vals.max())


def test_exact_mode_single_value_and_empty():
    sk = QuantileSketch()
    with pytest.raises(ValueError):
        sk.quantile(0.5)
    sk.add(3.25)
    assert sk.percentile(50) == 3.25 == sk.percentile(99)


# ------------------------------------------------------------ GK rank error

@pytest.mark.parametrize("order", ["random", "ascending", "descending"])
def test_gk_rank_error_bound(order):
    n, eps = 50_000, 0.01
    rng = np.random.default_rng(11)
    vals = rng.gamma(2.0, 0.5, size=n)
    if order == "ascending":
        vals = np.sort(vals)                       # adversarial: sorted feed
    elif order == "descending":
        vals = np.sort(vals)[::-1]
    sk = QuantileSketch(eps=eps, exact_cap=256)
    sk.extend(vals)
    srt = np.sort(vals)
    for q in QS:
        err = _rank_err(srt, sk.percentile(q), q)
        assert err <= 2 * eps * n, (
            f"p{q} rank error {err} exceeds 2*eps*n={2 * eps * n} "
            f"({order} insertion)")
    # footprint is the point: summary stays tiny relative to the stream
    assert sk.num_entries < 4_000


def test_gk_min_max_stay_exact():
    rng = np.random.default_rng(3)
    vals = rng.normal(size=20_000)
    sk = QuantileSketch(eps=0.02, exact_cap=64)
    sk.extend(vals)
    assert sk.percentile(0) == float(np.min(vals))
    assert sk.percentile(100) == float(np.max(vals))


# ------------------------------------------------------------------- merge

def test_merge_matches_single_stream_within_bound():
    n, eps = 30_000, 0.01
    rng = np.random.default_rng(23)
    vals = rng.exponential(1.0, size=n)
    chunks = np.array_split(vals, 3)
    sks = []
    for c in chunks:
        sk = QuantileSketch(eps=eps, exact_cap=128)
        sk.extend(c)
        sks.append(sk)
    left = sks[0].merge(sks[1]).merge(sks[2])      # (a ⊕ b) ⊕ c
    right = sks[0].merge(sks[1].merge(sks[2]))     # a ⊕ (b ⊕ c)
    srt = np.sort(vals)
    for m in (left, right):
        assert m.count == n
        assert m.maximum == float(vals.max())
        for q in QS:
            # merged error is the sum of the inputs' errors: 3 streams
            assert _rank_err(srt, m.percentile(q), q) <= 4 * eps * n
    # both association orders agree within the same bound
    for q in QS:
        assert abs(_rank_err(srt, left.percentile(q), q)
                   - _rank_err(srt, right.percentile(q), q)) <= 4 * eps * n


def test_merge_of_small_exact_sketches_stays_exact():
    a, b = QuantileSketch(), QuantileSketch()
    a.extend([1.0, 3.0, 5.0])
    b.extend([2.0, 4.0])
    m = a.merge(b)
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    for q in QS:
        assert m.percentile(q) == float(np.percentile(vals, q))


# ------------------------------------------------------------- determinism

def test_sketch_state_is_byte_stable():
    def build():
        sk = QuantileSketch(eps=0.02, exact_cap=32)
        rng = np.random.default_rng(5)
        sk.extend(rng.uniform(0, 10, size=5_000))
        return sk
    s1 = json.dumps(build().state(), sort_keys=True)
    s2 = json.dumps(build().state(), sort_keys=True)
    assert s1 == s2
    assert s1.encode() == s2.encode()              # the byte-level contract


def test_reservoir_is_seed_deterministic():
    def build(seed):
        r = ReservoirSample(capacity=64, seed=seed)
        for i in range(10_000):
            r.add(i)
        return r
    a, b = build(0), build(0)
    assert a.items == b.items
    assert len(a) == 64 and a.count == 10_000 and not a.exact
    assert build(1).items != a.items               # seed actually matters
    small = ReservoirSample(capacity=8, seed=0)
    for i in range(5):
        small.add(i)
    assert small.exact and small.items == [0, 1, 2, 3, 4]


def test_streaming_stat():
    s = StreamingStat()
    for v in (2.0, -1.0, 4.5):
        s.add(v)
    assert (s.count, s.minimum, s.maximum) == (3, -1.0, 4.5)
    assert s.mean == pytest.approx(5.5 / 3)


# ----------------------------------------------------- LatencyStats surface

def test_latency_stats_drops_raw_by_default():
    vals = list(np.random.default_rng(9).lognormal(size=300))
    st = LatencyStats.of(vals)
    assert st.values == [] and st.count == 300
    assert st.sketch is not None
    # arbitrary percentile answered from the sketch, exact at this size
    assert st.percentile(75) == float(np.percentile(vals, 75))
    kept = LatencyStats.of(vals, keep_raw=True)
    assert kept.values == [float(v) for v in vals]
    assert kept.p99 == st.p99


def test_latency_accumulator_matches_of_small_n():
    vals = list(np.random.default_rng(13).uniform(0, 1, size=400))
    acc = LatencyAccumulator()
    for v in vals:
        acc.add(v)
    a, b = acc.stats(), LatencyStats.of(vals)
    assert (a.p50, a.p90, a.p99) == (b.p50, b.p90, b.p99)
    assert a.count == b.count == 400
    assert a.mean == pytest.approx(b.mean)


def test_compare_distributions_on_sketch_backed_stats():
    rng = np.random.default_rng(17)
    base = rng.lognormal(0.0, 0.5, size=5_000)
    a = LatencyStats.of(base)
    b = LatencyStats.of(base * 1.02)               # 2% uniform shift
    d = compare_distributions(a, b)
    for k in ("p50_rel_err", "p90_rel_err", "p99_rel_err",
              "median_rel_err"):
        assert 0.0 <= d[k] <= 0.1
    same = compare_distributions(a, a)
    assert same["median_rel_err"] == 0.0


def test_compare_distributions_rejects_empty_side():
    full = LatencyStats.of([1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="has no samples"):
        compare_distributions(full, LatencyStats.of([]))
    with pytest.raises(ValueError, match="has no samples"):
        compare_distributions(LatencyStats(0.0, 0.0, 0.0, 0.0), full)


def test_stats_and_comparison_equal_the_reference():
    from repro.metrics import LatencyStats as RefStats
    from repro.metrics import compare_distributions as ref_compare

    rng = np.random.default_rng(3)
    a, b = rng.lognormal(-3, 0.5, 500).tolist(), rng.lognormal(-3, 0.6, 400).tolist()
    pa, pb, ra, rb = LatencyStats.of(a), LatencyStats.of(b), RefStats.of(a), RefStats.of(b)
    for q in ("mean", "p50", "p90", "p99"):
        assert getattr(pa, q) == getattr(ra, q)
    assert compare_distributions(pa, pb) == ref_compare(ra, rb)
