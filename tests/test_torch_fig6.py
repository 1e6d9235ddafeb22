"""The port's fig6 accuracy run (``repro_torch.launch.fig6_accuracy``) against
the reference's ``benchmarks/fig6_accuracy.py``, on the CPU.

* fig6's two streams (calibration: 15 requests, seed 123; evaluation: 30,
  seed 7) equal the reference's request for request, and its engine equals
  the reference's field by field; ``chip="h100-sxm"``, the card's engine,
  differs in ``chip`` alone.
* The emulated half exactly: one ``LinearPredictor`` fitted in each package
  on the same step samples, then each package's ``run_emulated`` on the same
  evaluation stream on a ``ManualWallSource`` (virtual time moves only
  through coordinated jumps): every request's TTFT and TPOT are equal,
  tolerance 0, for the three reduced architectures, at fig6's chip and at
  the card's.
* ``measure`` at reduced size in fp32: the row has exactly the reference's
  keys, every real request got its tokens, and the emulated phase launched
  nothing.
* The example ``examples/serve_real_vs_emulated_torch.py`` rehearses on the
  CPU.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import benchmarks.common as ref_common
import benchmarks.fig6_accuracy as ref_fig6
from repro.core.clock import ManualWallSource as RefManualWall
from repro.core.predictor import BatchSpec as RefBatchSpec
from repro.core.predictor import LinearPredictor as RefLinearPredictor
from repro.core.predictor import SeqSpec as RefSeqSpec
from repro_torch.core.clock import ManualWallSource
from repro_torch.core.predictor import BatchSpec, LinearPredictor, SeqSpec
from repro_torch.launch import fig6_accuracy as fig6
from repro_torch.launch import real_vs_emulated as rve

torch.set_num_threads(2)    # the suite runs in several workers at once

REPO = Path(__file__).resolve().parents[1]
FIG6_KEYS = ["arch", "n", "real_ttft_p50_ms", "emu_ttft_p50_ms", "ttft_p50_err",
             "ttft_p99_err", "tpot_p50_err", "tpot_p99_err", "real_noise_floor",
             "real_wall_s", "emu_wall_s", "speedup_vs_real"]


def _stream(reqs):
    first = reqs[0].request_id
    return [(r.request_id - first, r.arrival_time, list(r.prompt_tokens), r.max_new_tokens)
            for r in reqs]


@pytest.mark.parametrize("n,seed", [(15, 123), (30, 7)])
def test_streams_equal_the_reference(n, seed):
    """Ids (counted from the stream's first: the counter is global),
    arrival times, prompt tokens and output lengths, exactly."""
    ref = ref_common.small_workload(n=n, qps=15.0, seed=seed)
    got = fig6.small_workload(n=n, qps=15.0, seed=seed)
    assert len(got) == n
    assert _stream(got) == _stream(ref)


def test_engine_equals_the_reference():
    ref = dataclasses.asdict(ref_fig6.engine_cfg())
    assert dataclasses.asdict(fig6.engine_cfg()) == ref
    assert ref["enable_prefix_caching"] and ref["chip"] == "tpu-v5e"
    card = dataclasses.asdict(fig6.engine_cfg(chip="h100-sxm"))
    assert {k for k in ref if card[k] != ref[k]} == {"chip"}


def _samples(seed=6, steps=40):
    """Step samples as numbers: each step's (new_tokens, context_len) a
    sequence, and its seconds."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        seqs = []
        for _ in range(int(rng.integers(1, 9))):
            if rng.random() < 0.3:
                new = int(rng.integers(2, 64))
                seqs.append((new, new + int(rng.integers(0, 32))))
            else:
                seqs.append((1, int(rng.integers(4, 112))))
        out.append((seqs, float(rng.uniform(2e-3, 2e-2))))
    return out


def _fitted(predictor, batch, seq):
    predictor.fit([(batch.make([seq(*s) for s in seqs]), t) for seqs, t in _samples()])
    return predictor


@pytest.mark.timeout(300)
@pytest.mark.parametrize("chip", [None, "h100-sxm"])
@pytest.mark.parametrize("arch", fig6.ARCHS)
def test_emulated_timelines_equal_the_reference(monkeypatch, arch, chip):
    ref_build, port_build = ref_fig6.build_stack, rve.build_stack
    monkeypatch.setattr(ref_fig6, "build_stack",
                        lambda *a, **k: ref_build(*a, wall=RefManualWall(), **k))
    monkeypatch.setattr(rve, "build_stack",
                        lambda *a, **k: port_build(*a, wall=ManualWallSource(), **k))
    if chip is not None:
        ref_engine = ref_fig6.engine_cfg
        monkeypatch.setattr(ref_fig6, "engine_cfg", lambda **kw: ref_engine(chip=chip, **kw))
    ref_pred = _fitted(RefLinearPredictor(), RefBatchSpec, RefSeqSpec)
    pred = _fitted(LinearPredictor(), BatchSpec, SeqSpec)
    assert list(pred._coef) == list(ref_pred._coef)

    ref_reqs = ref_common.small_workload(n=30, qps=15.0, seed=7)
    reqs = fig6.small_workload(n=30, qps=15.0, seed=7)
    ref_res = ref_fig6.run_emulated(arch, ref_reqs, ref_pred)
    res, record = fig6.run_emulated(arch, reqs, pred, reduced=True, chip=chip, device="cpu")
    assert record["num_requests"] == 30 and not any(record["launches"].values())
    assert all(r.finished for r in reqs)
    assert [(r.ttft(), r.tpot()) for r in reqs] == [(r.ttft(), r.tpot()) for r in ref_reqs]
    assert res.ttft.values == ref_res.ttft.values and res.tpot.values == ref_res.tpot.values


@pytest.mark.timeout(300)
def test_measure_rehearses_on_the_cpu():
    facts = {}
    row = fig6.measure("qwen2_5_3b", n=10, reduced=True, device="cpu", dtype=torch.float32,
                       facts=facts)
    assert list(row) == FIG6_KEYS
    assert row["arch"] == "qwen2_5_3b" and row["n"] == 10
    assert all(np.isfinite(v) for k, v in row.items() if k != "arch")
    phases = facts["phases"]
    assert phases["calibration"]["num_requests"] == 10
    for key in ("real", "real2", "emulated"):
        assert phases[key]["num_requests"] == 10, key
        assert phases[key]["steps"] > 0
    assert not any(phases["emulated"]["launches"].values())
    assert phases["emulated"]["allocated_delta_bytes"] is None     # no card here
    assert facts["layers"] == facts["layers_of"] == 2 and facts["dtype"] == "float32"
    assert facts["emulated_chip"] == "tpu-v5e" and facts["name"] is None
    assert 0 <= facts["requests_parted"] <= 10


def test_run_real_raises_for_a_request_short_of_its_tokens(monkeypatch):
    """``run_real``'s check: a request that did not get its tokens."""
    reqs = fig6.small_workload(n=2, qps=15.0, seed=7)

    class Truncated(rve.BenchmarkRunner):
        def run(self, *a, **k):
            res = super().run(*a, **k)
            reqs[0].output_tokens.pop()
            return res

    monkeypatch.setattr(rve, "BenchmarkRunner", Truncated)
    model, params = fig6.build(fig6.model_config("granite_8b", reduced=True),
                               torch.device("cpu"), torch.float32)
    with pytest.raises(RuntimeError, match="tokens"):
        fig6.run_real("granite_8b", reqs, model, params, device="cpu", dtype=torch.float32)


def test_model_config_cuts_only_the_card_depth():
    assert fig6.model_config("mixtral_8x7b").num_layers == 16
    assert fig6.model_config("mixtral_8x7b").param_count() == 23_482_470_400
    assert fig6.model_config("granite_8b").num_layers == 36
    assert fig6.model_config("mixtral_8x7b", reduced=True).num_layers == 2


@pytest.mark.timeout(300)
def test_example_rehearses_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "examples/serve_real_vs_emulated_torch.py", "--reduced",
         "--device", "cpu", "--dtype", "float32"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "PYTHONDONTWRITEBYTECODE": "1",
             "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "phase 1: serving the real model" in out and "served 24 requests" in out
    assert "phase 2: re-serving the same stream" in out
    assert "fidelity (emulated vs real):" in out
    assert "TTFT p50  real" in out and "TPOT p50  real" in out
