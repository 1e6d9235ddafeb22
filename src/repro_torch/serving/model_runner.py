"""Model runners: where the serving engine crosses into device execution.

* :class:`RealModelRunner` executes the PyTorch model on the card (or on the
  CPU when asked) and is the ground truth that emulation is held against.  It
  also records one ``(BatchSpec, seconds)`` sample per step for fitting a
  predictor.
* :class:`TimeWarpModelRunner` is Revati: it predicts the step duration and
  requests a time jump instead of executing.  Weights and KV pool are
  ``ComputeBuffer``s on virtual devices; the returned tokens are a constant.
  It touches no device and allocates no tensor.
* :class:`SleepModelRunner` predicts, then sleeps the wall clock for the
  predicted time (the paper's strawman).

The two emulated runners, ``batch_spec_of`` and ``_producing`` are copies of
the reference's (``tests/test_torch_package.py`` holds them to it), so a
real step's ``BatchSpec`` equals the emulator's for the same batch.

The real runner does not copy four faults of the reference runner
(``repro.serving.model_runner.RealModelRunner``):

* F1 — a padded final prefill chunk returned the logits of a pad token.
  Here every prefill chunk runs at its exact length: eager PyTorch has no
  compile cache for buckets to serve, so there are no pads and no scratch
  region past ``max_len``.
* F2 — every decoded token sat one position late.  Here the fed token goes
  at position ``num_prefilled + num_generated - 1``, the first free one.
* F3 — the batched decode wrote into every slot, decoding or not.  Here only
  the slots that decode this step are read and written
  (``TransformerLM.decode_slots``).
* F4 — a prefix-cache hit prefilled from ``cached_prefix_len`` into an empty
  slot.  Here that raises ``NotImplementedError``: loading the cached
  prefix's KV into the slot is ROADMAP Queue A item F4.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

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


class RealModelRunner:
    """Executes the PyTorch model — ground truth for fidelity runs.

    A shared slot cache holds ``max_seqs`` rows of ``max_len`` positions (a
    multiple of the model's page size), or of recurrent state for an SSM, and
    is updated in place.  A step runs each prefill chunk on its own slot
    (batch 1, exact length: flash attention, or the SSD scan from the slot's
    carried state), then one decode over the slots that decode (paged
    attention, or the SSD step), then waits for the device; that wall time is
    the step's real duration.
    """

    def __init__(self, model, params, *, max_seqs: int, max_len: int,
                 clock: VirtualClock, device, dtype=torch.bfloat16):
        self.model = model
        self.params = params
        self.max_seqs = max_seqs
        self.max_len = max_len
        self.clock = clock
        self.device = torch.device(device)
        self.cache = model.init_cache(max_seqs, max_len, dtype, self.device)
        self._slot_of: Dict[int, int] = {}
        self._free_slots = list(range(max_seqs))[::-1]
        self._slot_len = [0] * max_seqs          # tokens in each slot, host copy
        self.samples: List[tuple] = []       # (BatchSpec, seconds) for fitting

    # ------------------------------------------------------------ warmup --
    def warmup(self, prefill_tokens: int) -> None:
        """One prefill chunk of ``prefill_tokens`` and one decode on slot 0,
        which is reset afterwards, so that loading the kernels and setting up
        the matrix-product library stay out of measured step times."""
        n = max(2, min(prefill_tokens, self.max_len - 1))
        toks = torch.zeros((1, n), dtype=torch.long, device=self.device)
        self.model.prefill(self.params, {"tokens": toks}, self._slot_view(0))
        self.model.decode_slots(self.params, self.cache, toks[:, :1],
                                torch.zeros(1, dtype=torch.long, device=self.device))
        self._sync()
        self._reset_slot(0)

    # ---------------------------------------------------- cache plumbing --
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _slot_view(self, slot: int):
        """Batch-1 view of one slot of the shared cache (writes go through)."""
        layers = self.cache["layers"]
        return {"layers": {k: v[:, slot:slot + 1] for k, v in layers.items()},
                "cache_len": self.cache["cache_len"][slot:slot + 1]}

    def _reset_slot(self, slot: int) -> None:
        """Empty a slot for a new request.  Attention KV is masked by its
        position tags; an SSM slot's state and conv state are the context
        itself, so they are zeroed, or the request would inherit them."""
        layers = self.cache["layers"]
        if "kv_pos" in layers:
            layers["kv_pos"][:, slot] = -1
        else:
            layers["state"][:, slot] = 0
            layers["conv"][:, slot] = 0
        self.cache["cache_len"][slot] = 0
        self._slot_len[slot] = 0

    # ------------------------------------------------------------ running --
    def execute(self, out: SchedulerOutput) -> Dict[int, int]:
        t0 = time.monotonic()
        picked: Dict[int, torch.Tensor] = {}

        prefills = [s for s in out.batch if s.is_prefill]
        decodes = [s for s in out.batch if not s.is_prefill]

        # ---- prefill chunks, per sequence, exact lengths (F1) ----
        for s in prefills:
            req = s.request
            start = req.num_prefilled
            slot = self._slot_of.get(req.request_id)
            if slot is None:
                if start > 0:
                    raise NotImplementedError(
                        f"request {req.request_id} starts prefill at position "
                        f"{start} (a prefix-cache hit) in an empty slot; the "
                        "cached prefix's KV is not loaded yet (ROADMAP Queue A "
                        "item F4, real prefix-KV sharing)")
                slot = self._free_slots.pop()
                self._slot_of[req.request_id] = slot
                self._reset_slot(slot)
            if start != self._slot_len[slot]:
                raise RuntimeError(
                    f"request {req.request_id}: prefill from {start} but its slot "
                    f"holds {self._slot_len[slot]} tokens")
            chunk = list(req.prompt_tokens[start:start + s.num_new_tokens])
            toks = torch.tensor([chunk], dtype=torch.long, device=self.device)
            logits, _ = self.model.prefill(self.params, {"tokens": toks},
                                           self._slot_view(slot))
            self._slot_len[slot] = start + len(chunk)
            if start + len(chunk) >= req.prompt_len:
                picked[req.request_id] = torch.argmax(logits[0])

        # ---- one decode over the decoding slots only (F2, F3) ----
        if decodes:
            slots, fed, pos = [], [], []
            for s in decodes:
                req = s.request
                slot = self._slot_of[req.request_id]
                p = req.num_prefilled + req.num_generated - 1
                if p != self._slot_len[slot]:
                    raise NotImplementedError(
                        f"request {req.request_id} decodes at position {p} but its "
                        f"slot holds {self._slot_len[slot]} tokens (a resumed "
                        "preemption replays only the prompt; ROADMAP Queue A "
                        "item P)")
                if p >= self.max_len:
                    raise ValueError(f"request {req.request_id} outgrows max_len "
                                     f"{self.max_len}")
                slots.append(slot)
                fed.append(req.output_tokens[-1])
                pos.append(p)
            slots_t = torch.tensor(slots, dtype=torch.long, device=self.device)
            self.cache["cache_len"][slots_t] = torch.tensor(
                pos, dtype=torch.int32, device=self.device)
            toks = torch.tensor(fed, dtype=torch.long, device=self.device)[:, None]
            logits = self.model.decode_slots(self.params, self.cache, toks, slots_t)
            for i, s in enumerate(decodes):
                self._slot_len[slots[i]] += 1
                picked[s.request.request_id] = torch.argmax(logits[i])

        self._sync()
        dt = time.monotonic() - t0
        self.samples.append((batch_spec_of(out), dt))
        ids = list(picked)
        values = torch.stack([picked[i] for i in ids]).tolist() if ids else []
        return dict(zip(ids, values))

    def release(self, request_id: int) -> None:
        slot = self._slot_of.pop(request_id, None)
        if slot is not None:
            self._free_slots.append(slot)

    @property
    def num_free_slots(self) -> int:
        return len(self._free_slots)

    def park(self) -> None: ...
    def unpark(self) -> None: ...
    def shutdown(self) -> None: ...
