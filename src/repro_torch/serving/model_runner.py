"""Model runners: where the serving engine crosses into device execution.

* :class:`TimeWarpModelRunner` is Revati: it predicts the step duration and
  requests a time jump instead of executing.  Weights and KV pool are
  ``ComputeBuffer``s on virtual devices; the returned tokens are a constant.
  It touches no device and allocates no tensor.
* :class:`SleepModelRunner` predicts, then sleeps the wall clock for the
  predicted time (the paper's strawman).
* The real runner, which executes the PyTorch model, is
  :class:`repro_torch.serving.real_runner.RealModelRunner`.  It lives in a
  module of its own so that this one imports no ``torch``: the emulated
  runners, and the replica processes of the cluster's process backend that
  import them, run without loading it, as the paper's "without physical
  GPUs" asks.

The two emulated runners, ``batch_spec_of`` and ``_producing`` are copies of
the reference's (``tests/test_torch_package.py`` holds them to it), so a
real step's ``BatchSpec`` equals the emulator's for the same batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.client import TimeJumpClient
from repro_torch.core.clock import VirtualClock
from repro_torch.core.emulation import VirtualDeviceContext
from repro_torch.core.predictor import BatchSpec, RuntimePredictor, SeqSpec

from .scheduler import ScheduledSeq, SchedulerOutput

DUMMY_TOKEN = 0  # emulated modes: values are never consumed by control flow


def batch_spec_of(out: SchedulerOutput) -> BatchSpec:
    seqs = []
    for s in out.batch:
        req = s.request
        seqs.append(SeqSpec(
            new_tokens=s.num_new_tokens,
            context_len=req.context_len + s.num_new_tokens,
            cached_prefix=req.cached_prefix_len if s.is_prefill else 0,
        ))
    return BatchSpec.make(tuple(seqs))


def _producing(out: SchedulerOutput) -> List[ScheduledSeq]:
    """Sequences that emit a token this step (decode + final prefill chunk)."""
    res = []
    for s in out.batch:
        req = s.request
        if not s.is_prefill:
            res.append(s)
        elif req.num_prefilled + s.num_new_tokens >= req.prompt_len:
            res.append(s)
    return res


class TimeWarpModelRunner:
    """Revati's device-side integration: ~20 effective lines of engine patch.

    Each ``execute`` asks the predictor "how long would this batch take on
    the target hardware?" and jumps virtual time by the answer through the
    Timekeeper.  With ``workers`` set, the jump is performed by every worker
    of the TP group plus a collective barrier (NCCL-as-barrier, §4.3).
    """

    def __init__(
        self,
        predictor: RuntimePredictor,
        client: Optional[TimeJumpClient] = None,
        *,
        workers: Optional["object"] = None,   # repro.serving.workers.WorkerGroup
        devices: Optional[VirtualDeviceContext] = None,
        weight_bytes: int = 0,
        kv_pool_bytes: int = 0,
    ):
        self.predictor = predictor
        self.client = client
        self.workers = workers
        self.devices = devices
        # per-step breakdown for the accuracy/split figures; audit modes
        # below "full" switch retention off so memory stays flat over
        # million-request streams (engine.set_audit flips the flag)
        self.retain_estimates = True
        self.step_estimates: List[dict] = []
        if devices is not None:
            n = len(devices.devices)
            self._buffers = []
            for d in range(n):
                if weight_bytes:
                    self._buffers.append(devices.malloc(
                        weight_bytes // n, d, tag="weights"))
                if kv_pool_bytes:
                    self._buffers.append(devices.malloc(
                        kv_pool_bytes // n, d, tag="kv_pool"))

    # ------------------------------------------------------------ running --
    def execute(self, out: SchedulerOutput) -> Dict[int, int]:
        est = self.predictor.predict_step(batch_spec_of(out))
        if self.retain_estimates:
            self.step_estimates.append(est.as_dict())
        if self.workers is not None:
            self.workers.execute_step(est.total)
        elif self.client is not None:
            self.client.time_jump(est.total)          # <-- the Revati patch
        return {s.request.request_id: DUMMY_TOKEN for s in _producing(out)}

    # actor lifecycle (engine parks when idle so it never wedges the barrier)
    def park(self) -> None:
        if self.workers is not None:
            self.workers.park()
        elif self.client is not None:
            self.client.park()

    def unpark(self) -> None:
        if self.workers is not None:
            self.workers.unpark()
        elif self.client is not None:
            self.client.unpark()

    def retire(self) -> None:
        """Permanent departure from the Timekeeper (cluster drain): a real
        deregistration — with the barrier re-evaluation + epoch bump that
        park lacks — so a drained replica is forgotten entirely."""
        if self.workers is not None:
            self.workers.park()          # WorkerGroup park == deregister all
        elif self.client is not None:
            self.client.deregister()

    def shutdown(self) -> None:
        self.park()
        if self.workers is not None:
            self.workers.shutdown()


class SleepModelRunner:
    """Strawman sleep-based emulation (§3.2): correct, wall-clock slow."""

    def __init__(self, predictor: RuntimePredictor, clock: VirtualClock):
        self.predictor = predictor
        self.clock = clock
        self.retain_estimates = True
        self.step_estimates: List[dict] = []

    def execute(self, out: SchedulerOutput) -> Dict[int, int]:
        est = self.predictor.predict_step(batch_spec_of(out))
        if self.retain_estimates:
            self.step_estimates.append(est.as_dict())
        # Precise (spin-tailed) sleep: plain time.sleep overshoots by OS timer
        # slop, which would systematically bias this baseline slow.
        self.clock.wall.sleep_precise(est.total)
        return {s.request.request_id: DUMMY_TOKEN for s in _producing(out)}

    def park(self) -> None: ...
    def unpark(self) -> None: ...
    def retire(self) -> None: ...
    def shutdown(self) -> None: ...
