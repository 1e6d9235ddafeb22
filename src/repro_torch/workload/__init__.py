"""Workload subsystem: open-loop streams, arrival processes, chat sessions.

- :mod:`repro.workload.arrival` — pluggable arrival processes (Poisson,
  gamma/bursty, on/off spikes, diurnal rate-trace replay).
- :mod:`repro.workload.synth` — open-loop request synthesis + trace replay
  (the former ``repro.serving.workload``; the compat shim is gone).
- :mod:`repro.workload.session` — closed-loop multi-turn sessions whose
  follow-ups carry the prior turn's tokens (drives the emulator *and* the
  DES through one object).
- :mod:`repro.workload.streaming` — lazy million-request forms of the
  above: bounded look-ahead streams for the flat-memory scale path.
"""

from .arrival import (ARRIVAL_PROCESSES, ArrivalProcess, GammaArrivals,
                      OnOffArrivals, PoissonArrivals, RateTraceArrivals,
                      UniformArrivals, make_arrival)
from .session import Session, SessionConfig, SessionWorkload, TurnSpec
from .streaming import (StreamingSessionWorkload, StreamingWorkload,
                        replay_trace_stream)
from .synth import WorkloadConfig, replay_trace, synthesize

__all__ = [
    "ARRIVAL_PROCESSES",
    "ArrivalProcess",
    "UniformArrivals",
    "PoissonArrivals",
    "GammaArrivals",
    "OnOffArrivals",
    "RateTraceArrivals",
    "make_arrival",
    "WorkloadConfig",
    "synthesize",
    "replay_trace",
    "SessionConfig",
    "SessionWorkload",
    "Session",
    "TurnSpec",
    "StreamingWorkload",
    "StreamingSessionWorkload",
    "replay_trace_stream",
]
