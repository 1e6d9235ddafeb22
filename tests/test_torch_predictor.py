"""The port's runtime predictors (``repro_torch.core.predictor``): the
reference's tests (``tests/test_predictor.py``) held against the port's copy,
and its estimates and fits against the reference's, bit for bit."""

import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                              # optional dev dependency
    from _hypothesis_compat import given, settings, st

from repro_torch.configs import get_config
from repro_torch.core.hardware import H100, TPU_V5E
from repro_torch.core.predictor import (AnalyticalPredictor, BatchSpec,
                                  ParallelSpec, SeqSpec, StaticPredictor,
                                  TablePredictor, collective_time)

import torch

torch.set_num_threads(2)    # the suite runs in several workers at once


def batch(*seqs):
    return BatchSpec.make([SeqSpec(*s) for s in seqs])


def test_static():
    p = StaticPredictor(0.02)
    assert p.predict_step(batch((1, 100))).total == 0.02


def test_collective_time_formulas():
    # all-reduce = 2(n-1)/n * B / bw_eff
    t = collective_time(1e9, 4, TPU_V5E, "all_reduce")
    bw = TPU_V5E.interconnect_bandwidth * TPU_V5E.collective_efficiency
    assert t == pytest.approx(2 * 0.75 * 1e9 / bw)
    assert collective_time(1e9, 1, TPU_V5E) == 0.0
    assert collective_time(1e9, 4, TPU_V5E, "all_gather") == pytest.approx(t / 2)


def test_analytical_decode_memory_bound():
    cfg = get_config("llama3_8b")
    pred = AnalyticalPredictor(cfg, ParallelSpec(tp=1), TPU_V5E)
    est = pred.predict_step(batch((1, 2048)))
    # single-token decode on an 8B model is overwhelmingly memory-bound
    assert est.memory > 5 * est.compute
    # weight streaming floor: params * 2B / (bw*eff)
    floor = cfg.param_count() * 2 / (TPU_V5E.hbm_bandwidth * TPU_V5E.hbm_efficiency)
    assert est.total >= 0.8 * floor


def test_analytical_prefill_compute_bound():
    cfg = get_config("llama3_8b")
    pred = AnalyticalPredictor(cfg, ParallelSpec(tp=1), H100)
    est = pred.predict_step(batch((4096, 4096)))
    assert est.compute > est.memory


def test_analytical_monotonicity():
    cfg = get_config("qwen2_5_3b")
    pred = AnalyticalPredictor(cfg, ParallelSpec(tp=1), TPU_V5E)
    t1 = pred.predict_step(batch((1, 512))).total
    t2 = pred.predict_step(batch((1, 512), (1, 512))).total
    t3 = pred.predict_step(batch((256, 512))).total
    assert t2 >= t1
    assert t3 > t1


def test_tp_reduces_time_adds_collectives():
    cfg = get_config("llama3_70b")
    t1 = AnalyticalPredictor(cfg, ParallelSpec(tp=1), TPU_V5E).predict_step(
        batch((512, 512)))
    t4 = AnalyticalPredictor(cfg, ParallelSpec(tp=4), TPU_V5E).predict_step(
        batch((512, 512)))
    assert t4.total < t1.total
    assert t4.collective_bytes > 0
    assert t1.collective_bytes == 0


def test_moe_cheaper_than_dense_equivalent():
    """MoE top-2/8 should cost ~active params, not total params."""
    moe = get_config("mixtral_8x7b")
    pred = AnalyticalPredictor(moe, ParallelSpec(tp=1), H100)
    est = pred.predict_step(batch((2048, 2048)))
    # compute should track 6*N_active, far below 6*N_total
    dense_flops_all = 2 * moe.param_count() * 2048
    assert est.flops < 0.6 * dense_flops_all


def test_sliding_window_caps_decode_cost():
    cfg = get_config("mixtral_8x7b")          # SWA 4096
    pred = AnalyticalPredictor(cfg, ParallelSpec(tp=1), H100)
    near = pred.predict_step(batch((1, 4096))).total
    far = pred.predict_step(batch((1, 500_000))).total
    assert far <= near * 1.05                 # window bounds KV reads


def test_table_predictor_fit_and_interp():
    tp = TablePredictor()
    tp.fit([
        (batch((512, 512)), 0.020),
        (batch((1, 600), (1, 600)), 0.004),
        (batch((256, 256)), 0.011),
    ])
    est = tp.predict_step(batch((512, 512)))
    assert est.total == pytest.approx(0.020, rel=0.15)
    with pytest.raises(RuntimeError):
        TablePredictor().predict_step(batch((1, 1)))


@settings(max_examples=30, deadline=None)
@given(
    n_decode=st.integers(0, 64),
    ctx=st.integers(16, 8192),
    chunk=st.integers(0, 2048),
)
def test_property_estimates_positive_and_bounded(n_decode, ctx, chunk):
    cfg = get_config("qwen2_5_3b")
    pred = AnalyticalPredictor(cfg, ParallelSpec(tp=1), TPU_V5E)
    seqs = [(1, ctx)] * n_decode + ([(chunk, chunk)] if chunk else [])
    if not seqs:
        return
    est = pred.predict_step(BatchSpec.make([SeqSpec(*s) for s in seqs]))
    assert est.total > 0
    assert est.total < 60.0            # nothing takes a virtual minute
    assert est.flops > 0


@pytest.mark.parametrize("arch", ["llama3_8b", "llama3_70b", "mixtral_8x7b", "mamba2_370m"])
def test_estimates_equal_the_reference(arch):
    """The analytical model on H100 and a linear fit give the reference's
    numbers exactly for the same batches."""
    import numpy as np

    from repro.configs import get_config as ref_config
    from repro.core import hardware as ref_hw
    from repro.core import predictor as ref
    from repro_torch.core.predictor import LinearPredictor

    rng = np.random.default_rng(0)
    shapes = [[(int(rng.integers(1, 512)) if i == 0 else 1, int(rng.integers(1, 4096)))
               for i in range(int(rng.integers(1, 9)))] for _ in range(40)]
    port_batches = [batch(*s) for s in shapes]
    ref_batches = [ref.BatchSpec.make([ref.SeqSpec(*x) for x in s]) for s in shapes]
    for tp in (1, 2):
        pa = AnalyticalPredictor(get_config(arch), ParallelSpec(tp=tp), H100)
        ra = ref.AnalyticalPredictor(ref_config(arch), ref.ParallelSpec(tp=tp), ref_hw.H100)
        for pb, rb in zip(port_batches, ref_batches):
            assert pa.predict_step(pb).as_dict() == ra.predict_step(rb).as_dict()
    secs = rng.uniform(1e-3, 5e-2, len(shapes)).tolist()
    pl, rl = LinearPredictor(), ref.LinearPredictor()
    pl.fit(list(zip(port_batches, secs)))
    rl.fit(list(zip(ref_batches, secs)))
    for pb, rb in zip(port_batches, ref_batches):
        assert pl.predict_step(pb).as_dict() == rl.predict_step(rb).as_dict()
