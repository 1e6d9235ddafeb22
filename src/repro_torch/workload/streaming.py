"""Lazy workloads: million-request streams with bounded look-ahead.

The eager synthesizers (:func:`repro.workload.synth.synthesize`,
:class:`repro.workload.session.SessionWorkload`) materialize every request
up front — fine for figure-sized runs, impossible for the ROADMAP's
"millions of users" scale where the request list alone would dwarf the
emulator's own state.  This module provides the streaming forms:

- :class:`StreamingWorkload` — open-loop: a re-iterable request *stream*.
  Each iteration replays the identical stream (fresh seeded generators per
  ``__iter__``), so the emulator and the DES can consume the same workload
  object and still see byte-identical requests — the parity bar survives
  streaming.  Arrival times come from
  :meth:`~repro.workload.arrival.ArrivalProcess.iter_times`; lengths and
  token bodies are drawn from **independent per-component substreams**
  (``default_rng([seed, ns])``), which makes the stream chunk-size
  invariant.  Look-ahead memory is O(chunk).
- :class:`StreamingSessionWorkload` — closed-loop: same release rule as
  :class:`~repro.workload.session.SessionWorkload` (``follow_up`` on
  completion), but turns are materialized **per live session** from
  per-session substreams (``default_rng([seed, ns, sid])``) and dropped when
  the session's last turn completes.  A cheap shape-only pre-pass (lengths,
  no token bodies) fixes ``total_requests`` exactly without ever holding
  token arrays, so memory tracks *concurrently open* sessions.
- :func:`replay_trace_stream` — streaming trace replay over arbitrary
  (possibly lazy) arrival/length iterables.

Streams produced here are *new* deterministic streams — they do not
reproduce the eager synthesizers' draw order (which is regression-pinned and
unchanged).  What is guaranteed: same config ⇒ same stream, every time, on
every backend.
"""

from __future__ import annotations

import threading
from array import array
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from repro_torch.serving.request import Request

from .arrival import ArrivalProcess, make_arrival
from .session import _DUMMY, SessionConfig, TurnSpec
from .synth import WorkloadConfig, lognormal_lengths

__all__ = ["StreamingWorkload", "StreamingSessionWorkload",
           "replay_trace_stream"]

# Substream namespaces: seeding with a sequence ([seed, ns] / [seed, ns, sid])
# gives independent deterministic generators per component, so interleaving
# (and chunk size) cannot shuffle draws between components.
_NS_ARRIVAL = 1
_NS_PROMPT_LEN = 2
_NS_OUTPUT_LEN = 3
_NS_BODY = 4
_NS_SHARED = 5
_NS_SHAPE = 6


def _shared_prefix(seed: int, vocab_size: int, length: int) -> List[int]:
    if not length:
        return []
    rng = np.random.default_rng([seed, _NS_SHARED])
    return rng.integers(1, vocab_size, size=length).tolist()


class StreamingWorkload:
    """Open-loop lazy request stream (the ``synthesize`` counterpart).

    Iterating yields ``cfg.num_requests`` arrival-sorted requests without
    ever holding more than one draw chunk; ``expected`` carries the declared
    request count so :class:`~repro.serving.benchmark.BenchmarkRunner` and
    the DES never fall back to ``len(requests)``.

    >>> sw = StreamingWorkload(WorkloadConfig(num_requests=5, seed=3))
    >>> sw.expected
    5
    >>> a = [r.prompt_tokens for r in sw]
    >>> b = [r.prompt_tokens for r in sw]      # re-iterable, byte-identical
    >>> a == b
    True
    """

    def __init__(self, cfg: WorkloadConfig,
                 arrival: Optional[ArrivalProcess] = None, chunk: int = 256):
        assert chunk > 0
        self.cfg = cfg
        self.chunk = int(chunk)
        self._proc = arrival or make_arrival(cfg.arrival, cfg.qps,
                                             **(cfg.arrival_kwargs or {}))
        self.expected = cfg.num_requests

    @property
    def total_requests(self) -> int:
        return self.expected

    def __iter__(self) -> Iterator[Request]:
        cfg = self.cfg
        shared = _shared_prefix(cfg.seed, cfg.vocab_size,
                                cfg.shared_prefix_len)
        times = self._proc.iter_times(
            np.random.default_rng([cfg.seed, _NS_ARRIVAL]), chunk=self.chunk)
        rng_plen = np.random.default_rng([cfg.seed, _NS_PROMPT_LEN])
        rng_olen = np.random.default_rng([cfg.seed, _NS_OUTPUT_LEN])
        rng_body = np.random.default_rng([cfg.seed, _NS_BODY])
        emitted = 0
        while emitted < cfg.num_requests:
            m = min(self.chunk, cfg.num_requests - emitted)
            plens = lognormal_lengths(rng_plen, m, cfg.prompt_len_mean,
                                      cfg.prompt_len_sigma,
                                      cfg.min_prompt_len, cfg.max_prompt_len)
            olens = lognormal_lengths(rng_olen, m, cfg.output_len_mean,
                                      cfg.output_len_sigma,
                                      cfg.min_output_len, cfg.max_output_len)
            for i in range(m):
                body_len = max(int(plens[i]) - len(shared), 1)
                body = rng_body.integers(1, cfg.vocab_size,
                                         size=body_len).tolist()
                yield Request(
                    prompt_tokens=shared + body,
                    max_new_tokens=int(olens[i]),
                    arrival_time=float(next(times)),
                )
            emitted += m

    def __len__(self) -> int:
        return self.expected


class StreamingSessionWorkload:
    """Closed-loop sessions with per-live-session materialization.

    Same observable contract as :class:`SessionWorkload` — an initial
    arrival-sorted stream of turn-0 requests plus the ``follow_up`` release
    rule — but token bodies exist only for sessions currently in flight.
    The shape pre-pass (turn counts, honoring the ``max_context_len``
    early-stop, without drawing a single token) runs once at construction:
    O(num_sessions) time, O(num_sessions) *ints* of memory (the turn-count
    table), never O(total tokens).

    Thread-safe: completion contexts on all backends may call ``follow_up``
    concurrently; the live-session cache is lock-protected.  Re-iterable:
    each ``initial_stream()`` replays the identical stream, so one object
    drives an emulator run and a DES run back to back.
    """

    def __init__(self, cfg: SessionConfig,
                 arrival: Optional[ArrivalProcess] = None, chunk: int = 256):
        self.cfg = cfg
        self.chunk = int(chunk)
        self._proc = arrival or make_arrival(cfg.arrival, cfg.qps,
                                             **(cfg.arrival_kwargs or {}))
        self._shared = _shared_prefix(cfg.seed, cfg.vocab_size,
                                      cfg.shared_prefix_len)
        self._lock = threading.Lock()
        self._live: Dict[int, List[TurnSpec]] = {}
        # shape-only pre-pass: exact turn counts, zero token draws
        counts = array("i")
        total = 0
        alive = 0
        for sid in range(cfg.num_sessions):
            n = len(self._shape(sid))
            counts.append(n)
            total += n
            alive += int(n > 0)
        self._turn_counts = counts
        self.total_requests = total
        self.num_sessions = alive
        self.expected = total

    # ------------------------------------------------------------- shapes --
    def _shape(self, sid: int):
        """(body_len, max_new_tokens, think_time) per surviving turn —
        the context-cap early-stop applied without materializing tokens."""
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, _NS_SHAPE, sid])
        n_turns = int(min(cfg.max_turns,
                          rng.geometric(min(1.0, 1.0 / cfg.turns_mean))))
        first_len = int(lognormal_lengths(
            rng, 1, cfg.prompt_len_mean, cfg.prompt_len_sigma,
            cfg.min_prompt_len, cfg.max_context_len)[0])
        follow_lens = lognormal_lengths(
            rng, n_turns, cfg.followup_len_mean, cfg.followup_len_sigma,
            1, cfg.max_context_len)
        out_lens = lognormal_lengths(
            rng, n_turns, cfg.output_len_mean, cfg.output_len_sigma,
            cfg.min_output_len, cfg.max_output_len)
        thinks = rng.exponential(cfg.think_time_mean, size=n_turns)
        shape = []
        ctx = len(self._shared)
        for t in range(n_turns):
            body_len = (max(first_len - len(self._shared), 1) if t == 0
                        else int(follow_lens[t]))
            if ctx + body_len > cfg.max_context_len:
                break                     # context full: session ends early
            out = int(out_lens[t])
            shape.append((body_len, out,
                          0.0 if t == 0 else float(thinks[t])))
            ctx += body_len + out
        return shape

    def _materialize(self, sid: int) -> List[TurnSpec]:
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, _NS_BODY, sid])
        context: List[int] = list(self._shared)
        specs: List[TurnSpec] = []
        for body_len, out, think in self._shape(sid):
            body = rng.integers(1, cfg.vocab_size, size=body_len).tolist()
            prompt = context + body
            specs.append(TurnSpec(prompt_tokens=prompt,
                                  max_new_tokens=out, think_time=think))
            context = prompt + [_DUMMY] * out
        return specs

    def session_turns(self, session_id: int) -> int:
        return self._turn_counts[session_id]

    # ------------------------------------------------------------- release --
    def _request(self, sid: int, turn: int, arrival: float) -> Request:
        with self._lock:
            specs = self._live.get(sid)
            if specs is None:
                specs = self._live[sid] = self._materialize(sid)
        spec = specs[turn]
        return Request(
            prompt_tokens=list(spec.prompt_tokens),
            max_new_tokens=spec.max_new_tokens,
            arrival_time=arrival,
            session_id=sid,
            turn_index=turn,
        )

    def initial_stream(self) -> Iterator[Request]:
        """Turn 0 of every session, arrival-sorted, lazily materialized."""
        cfg = self.cfg
        times = self._proc.iter_times(
            np.random.default_rng([cfg.seed, _NS_ARRIVAL]), chunk=self.chunk)
        for sid in range(cfg.num_sessions):
            t = next(times)               # every session consumes its slot
            if self._turn_counts[sid] == 0:
                continue                  # first turn never fit the context
            yield self._request(sid, 0, float(t))

    def follow_up(self, finished) -> Optional[Request]:
        """Closed-loop release rule (same contract as
        :meth:`SessionWorkload.follow_up`); additionally *evicts* the
        session's materialized turns once its last turn has finished."""
        sid = getattr(finished, "session_id", None)
        if sid is None:
            return None
        turn = finished.turn_index + 1
        if turn >= self._turn_counts[sid]:
            with self._lock:
                self._live.pop(sid, None)     # session over: free its tokens
            return None
        assert finished.finish_time is not None, "follow_up needs finish_time"
        with self._lock:
            specs = self._live.get(sid)
            if specs is None:
                specs = self._live[sid] = self._materialize(sid)
        think = specs[turn].think_time
        return self._request(sid, turn, finished.finish_time + think)

    @property
    def live_sessions(self) -> int:
        """Sessions currently holding materialized token arrays."""
        with self._lock:
            return len(self._live)


class replay_trace_stream:
    """Streaming trace replay: the lazy counterpart of
    :func:`repro.workload.synth.replay_trace`.

    Accepts arbitrary iterables (lists, generators, file readers) for the
    arrival/length columns and yields requests one at a time; token bodies
    are drawn per request from a seeded generator, so nothing is
    materialized beyond the request in flight.  Re-iterable only when the
    input columns are (pass lists/tuples, or re-create the object).

    ``expected`` is taken from ``len(arrivals)`` when the column is sized,
    else it must be passed explicitly — the runner refuses to guess.
    """

    def __init__(self, arrivals: Iterable[float],
                 prompt_lens: Iterable[int], output_lens: Iterable[int], *,
                 vocab_size: int = 32000, seed: int = 0,
                 expected: Optional[int] = None):
        self._arrivals = arrivals
        self._prompt_lens = prompt_lens
        self._output_lens = output_lens
        self.vocab_size = vocab_size
        self.seed = seed
        if expected is None and hasattr(arrivals, "__len__"):
            expected = len(arrivals)  # type: ignore[arg-type]
        self.expected = expected

    @property
    def total_requests(self) -> Optional[int]:
        return self.expected

    def __iter__(self) -> Iterator[Request]:
        rng = np.random.default_rng([self.seed, _NS_BODY])
        for a, p, o in zip(self._arrivals, self._prompt_lens,
                           self._output_lens):
            yield Request(
                prompt_tokens=rng.integers(1, self.vocab_size,
                                           size=int(p)).tolist(),
                max_new_tokens=int(o),
                arrival_time=float(a),
            )
