"""The port's control plane against the reference's, preset by preset.

``repro_torch.cluster``, ``des``, ``scenario`` and ``fleet`` are copies of
the reference's modules, held line for line by the drift check
(``tests/test_torch_package.py``).  This file holds them by behaviour: each
preset runs through ``repro.scenario.run`` and ``repro_torch.scenario.run``
on the same backend, and the timelines must be equal, not close.  The thread
backend runs on a ``ManualWallSource`` (virtual time moves only by the
Timekeeper's jumps) and the DES has no wall at all, so both are exact.
``scale_stream`` runs on the DES only: its thread run takes too long for
the suite.

The process backend runs on the host's wall, so it is not compared
exactly; the port's own ``compare`` holds it to the thread backend within
one slow step, the reference's parity bar, and raises ``ParityError``
otherwise.
"""

import pytest

from repro.scenario import get_preset as ref_get_preset
from repro.scenario import run as ref_run
from repro_torch.scenario import compare, get_preset, run

pytestmark = pytest.mark.timeout(300)

BOTH = ["cluster_scaling", "autoscale_burst", "hetero_mix", "crash_recovery",
        "chaos_spot", "fleet_mix", "distributed_parity", "elastic_tier_parity"]
CASES = ([(name, "thread") for name in BOTH] + [(name, "des") for name in BOTH]
         + [("scale_stream", "des")])

# what a run decides and when, in virtual time: equal between the packages
FIELDS = ("latencies", "routing_decisions", "makespan_virtual", "num_steps",
          "faults_injected", "requests_requeued", "requests_failed")


@pytest.mark.parametrize("name,backend", CASES)
def test_port_timeline_equals_reference(name, backend):
    ref = ref_run(ref_get_preset(name), backend, timeout=120)
    got = run(get_preset(name), backend, timeout=120)
    assert got.num_requests == ref.num_requests > 0
    for field in FIELDS:
        assert getattr(got, field) == getattr(ref, field), f"{name}/{backend}: {field}"
    for stat in ("ttft", "tpot", "e2e"):
        assert _summary(getattr(got, stat)) == _summary(getattr(ref, stat)), \
            f"{name}/{backend}: {stat}"


def _summary(stats):
    """A LatencyStats of either package as plain numbers (its quantile
    sketch is an object of the package; ``latencies`` holds every sample)."""
    return {k: v for k, v in vars(stats).items() if k != "sketch"}


@pytest.mark.parametrize("wire", ["process-shm", "process-tcp"])
def test_port_compare_thread_against_process(wire):
    res = compare(get_preset("distributed_parity"), backends=("thread", wire), timeout=120)
    assert res.completed_equal and res.decisions_equal
    assert res.max_ttft_err_s <= res.slow_step_s
    assert res.max_tpot_err_s <= res.slow_step_s

