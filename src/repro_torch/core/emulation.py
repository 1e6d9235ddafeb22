"""Device Emulation Layer (paper §4.3), adapted from CUDA/LD_PRELOAD to JAX.

The paper intercepts CUDA driver calls so unmodified framework code "believes
it has access to target hardware".  JAX has no interceptable driver API, but
it has something better suited: the trace/compile path is *already* separated
from execution.  This module provides the pieces the serving substrate uses to
run GPU-free:

* :class:`VirtualDeviceContext` — a registry of virtual devices with HBM
  accounting, implementing the paper's **split-state memory model**:

  - *metadata buffers* (small, < 4 MB by default, potentially read by the
    control plane) are backed by real host memory and behave faithfully;
  - *compute buffers* (weights, KV cache) get virtual handles with **no
    physical backing**; any CPU read raises :class:`PhantomReadError` — a
    successful emulation run therefore *proves* the control plane never
    operated on phantom data (the paper's invariant, verbatim).

* :class:`EmulatedCollective` — NCCL-collective-as-barrier (paper:
  "We convert NCCL collectives into barrier synchronization points across
  participating workers, preserving temporal ordering without data
  transfer.").  Participants exchange virtual timestamps; everyone leaves at
  ``max(entry times) + predicted collective duration``.

* :class:`EmulatedChannel` — point-to-point send/recv with virtual
  timestamps, used for pipeline-parallel stage handoff and PD-disaggregation
  KV transfer.  A receiver can never observe a message "before" it was sent
  in virtual time.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .hardware import ChipSpec, TPU_V5E

__all__ = [
    "PhantomReadError",
    "VirtualOOMError",
    "Buffer",
    "MetadataBuffer",
    "ComputeBuffer",
    "VirtualDevice",
    "VirtualDeviceContext",
    "EmulatedCollective",
    "EmulatedChannel",
]

METADATA_THRESHOLD_BYTES = 4 * 1024 * 1024  # paper §4.3: 4 MB default


class PhantomReadError(RuntimeError):
    """The control plane attempted to read a compute buffer with no backing.

    Raised as a *fatal* fault rather than returning garbage (paper §4.3) —
    the alternative silently corrupts control decisions.
    """


class VirtualOOMError(RuntimeError):
    """Virtual HBM capacity exceeded — the configuration would OOM on the
    target hardware.  This is a *prediction*, and a feature: capacity planning
    without owning the cluster."""


class Buffer:
    __slots__ = ("nbytes", "device_id", "tag", "freed")

    def __init__(self, nbytes: int, device_id: int, tag: str):
        self.nbytes = int(nbytes)
        self.device_id = device_id
        self.tag = tag
        self.freed = False


class MetadataBuffer(Buffer):
    """Small allocation, really backed by host memory; reads/writes faithful."""

    __slots__ = ("data",)

    def __init__(self, nbytes: int, device_id: int, tag: str):
        super().__init__(nbytes, device_id, tag)
        self.data = np.zeros(nbytes, dtype=np.uint8)

    def write(self, payload: np.ndarray, offset: int = 0) -> None:
        raw = payload.view(np.uint8).reshape(-1)
        self.data[offset : offset + raw.size] = raw

    def read(self, nbytes: Optional[int] = None, offset: int = 0) -> np.ndarray:
        n = self.nbytes - offset if nbytes is None else nbytes
        return self.data[offset : offset + n]


class ComputeBuffer(Buffer):
    """Large allocation with a virtual pointer and no physical backing.

    Writes are accounted no-ops; reads fault.  ``shape``/``dtype`` are kept
    for introspection (the emulated runner hands out matching
    ``jax.ShapeDtypeStruct`` stand-ins).
    """

    __slots__ = ("shape", "dtype", "writes")

    def __init__(self, nbytes, device_id, tag, shape=None, dtype=None):
        super().__init__(nbytes, device_id, tag)
        self.shape = shape
        self.dtype = dtype
        self.writes = 0

    def write(self, *_args, **_kw) -> None:
        self.writes += 1  # accounted no-op

    def read(self, *_args, **_kw):
        raise PhantomReadError(
            f"CPU read of virtual compute buffer {self.tag!r} "
            f"({self.nbytes} B on device {self.device_id}); the control plane "
            "must never consume phantom data — classify this allocation as "
            "metadata if it is legitimately control-plane state."
        )


@dataclass
class VirtualDevice:
    device_id: int
    chip: ChipSpec
    allocated: int = 0
    peak: int = 0
    n_alloc: int = 0
    n_free: int = 0

    def alloc(self, nbytes: int, tag: str) -> None:
        if self.allocated + nbytes > self.chip.hbm_capacity:
            raise VirtualOOMError(
                f"device {self.device_id} ({self.chip.name}): allocating "
                f"{nbytes/1e9:.2f} GB on top of {self.allocated/1e9:.2f} GB "
                f"exceeds HBM capacity {self.chip.hbm_capacity/1e9:.1f} GB "
                f"(tag={tag!r})"
            )
        self.allocated += nbytes
        self.peak = max(self.peak, self.allocated)
        self.n_alloc += 1

    def free(self, nbytes: int) -> None:
        self.allocated -= nbytes
        self.n_free += 1


class VirtualDeviceContext:
    """Presents ``num_devices`` virtual chips to the serving substrate.

    The serving engine's emulated model runner allocates its weights and KV
    cache here instead of on real devices; block tables and batch metadata go
    through the metadata path so scheduler logic is *faithfully executed*,
    never modeled.
    """

    def __init__(
        self,
        num_devices: int,
        chip: ChipSpec = TPU_V5E,
        *,
        metadata_threshold: int = METADATA_THRESHOLD_BYTES,
    ):
        self.chip = chip
        self.metadata_threshold = metadata_threshold
        self.devices = [VirtualDevice(i, chip) for i in range(num_devices)]
        self._lock = threading.Lock()
        self._live: Dict[int, Buffer] = {}
        self._next_ptr = 0x10_0000_0000  # cosmetic virtual address space

    # --------------------------------------------------------------- api --
    def malloc(
        self,
        nbytes: int,
        device_id: int = 0,
        tag: str = "anon",
        *,
        shape=None,
        dtype=None,
        force_metadata: bool = False,
    ) -> Buffer:
        """Split-state allocation: metadata below threshold, virtual above."""
        with self._lock:
            dev = self.devices[device_id]
            dev.alloc(nbytes, tag)
            if force_metadata or nbytes < self.metadata_threshold:
                buf: Buffer = MetadataBuffer(nbytes, device_id, tag)
            else:
                buf = ComputeBuffer(nbytes, device_id, tag, shape=shape, dtype=dtype)
            self._next_ptr += max(256, nbytes)
            self._live[id(buf)] = buf
            return buf

    def free(self, buf: Buffer) -> None:
        with self._lock:
            if buf.freed:
                raise RuntimeError(f"double free of buffer {buf.tag!r}")
            buf.freed = True
            self._live.pop(id(buf), None)
            self.devices[buf.device_id].free(buf.nbytes)

    def memory_report(self) -> dict:
        with self._lock:
            return {
                "chip": self.chip.name,
                "num_devices": len(self.devices),
                "per_device_peak_bytes": [d.peak for d in self.devices],
                "per_device_live_bytes": [d.allocated for d in self.devices],
                "live_buffers": len(self._live),
            }


class EmulatedCollective:
    """A collective as a virtual-time barrier across ``group_size`` workers.

    Entry i arrives with its local virtual time ``t_i``; everyone leaves the
    collective at ``max_i(t_i) + duration``.  The *data* never moves — only
    the causal ordering and the time cost are preserved, exactly the paper's
    NCCL treatment.  Workers then time-jump to the exit timestamp.
    """

    def __init__(self, group_size: int, name: str = "collective"):
        self.group_size = group_size
        self.name = name
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._entries: List[float] = []
        self._generation = 0
        self._exit_time: Optional[float] = None

    def arrive(self, t_virtual: float, duration: float, timeout: float = 60.0,
               before_wait=None, after_wait=None) -> float:
        """Block (wall-clock) until all workers arrive; return exit virtual time.

        ``duration`` is the predicted collective cost; the max over the group
        is used (participants of one collective see one cost, but PP groups
        may pass stage-dependent estimates).

        ``before_wait``/``after_wait`` hooks fire only for ranks that
        actually block (not for the group-completing rank).  Worker actors
        use them to deregister from the Timekeeper while parked in the
        collective — a rank waiting on its peers must not hold the virtual
        clock hostage, while the completing rank stays registered so outside
        actors (e.g. the benchmark dispatcher) cannot race virtual time past
        the collective's exit before the group resumes.
        """
        with self._cond:
            gen = self._generation
            self._entries.append(max(t_virtual + duration, t_virtual))
            if len(self._entries) == self.group_size:
                self._exit_time = max(self._entries)
                self._entries = []
                self._generation += 1
                self._cond.notify_all()
                return self._exit_time
            if before_wait is not None:
                before_wait()
            try:
                while self._generation == gen:
                    if not self._cond.wait(timeout=timeout):
                        raise TimeoutError(
                            f"collective {self.name!r}: straggler barrier timed "
                            f"out ({self.group_size} expected)"
                        )
            finally:
                if after_wait is not None:
                    after_wait()
            assert self._exit_time is not None
            return self._exit_time


@dataclass
class _Message:
    payload: object
    t_sent: float
    nbytes: int


class EmulatedChannel:
    """P2P channel with virtual timestamps (PP stage handoff, KV transfer).

    ``recv`` returns ``(payload, t_visible)`` where ``t_visible`` is the
    virtual time at which the receiver may act on the message:
    ``t_sent + nbytes / bandwidth``.  The receiver is responsible for
    time-jumping to ``t_visible`` if its own clock is behind — this preserves
    the paper's causal dependency ("stage i+1 cannot proceed until stage i
    completes ncclSend") without moving tensor data.
    """

    def __init__(self, bandwidth: float = 50e9, name: str = "channel"):
        self.bandwidth = bandwidth
        self.name = name
        self._q: "deque[_Message]" = deque()
        self._cond = threading.Condition()

    def send(self, payload: object, t_virtual: float, nbytes: int = 0) -> float:
        """Enqueue; returns ``t_visible`` so senders can hand the deadline
        to a mover without a racy recv round-trip."""
        with self._cond:
            self._q.append(_Message(payload, t_virtual, nbytes))
            self._cond.notify_all()
        return t_virtual + (nbytes / self.bandwidth if self.bandwidth > 0
                            else 0.0)

    def recv(self, timeout: float = 60.0) -> Tuple[object, float]:
        with self._cond:
            while not self._q:
                if not self._cond.wait(timeout=timeout):
                    raise TimeoutError(f"channel {self.name!r}: recv timed out")
            msg = self._q.popleft()
        transfer = msg.nbytes / self.bandwidth if self.bandwidth > 0 else 0.0
        return msg.payload, msg.t_sent + transfer

    def poll(self) -> bool:
        with self._cond:
            return bool(self._q)
