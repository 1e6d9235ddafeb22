"""Closed-loop session workloads: multi-turn conversations.

A *session* is a chat: turn ``k+1`` is released only after turn ``k``
completes plus a sampled think time — a closed feedback loop, unlike the
open-loop streams from :mod:`repro.workload.synth`.  Each follow-up prompt
*carries the prior turn's tokens* (previous prompt + previous output + the
new user message), so the growing per-session context exercises
``prefix_affinity`` routing and the radix cache with real reuse instead of a
synthetic shared prefix.

Determinism: every token and length is pre-sampled at construction.  Emulated
outputs are always ``DUMMY_TOKEN`` (0) — the control plane never consumes
token *values* (paper §3.3) — so follow-up prompts are precomputable as
``prev_prompt + [0]*prev_output_len + next_body``.  Only the *release times*
of turns ≥ 1 are runtime-dependent (completion + think time), which is
exactly the coupling the closed loop exists to model.  The same
:class:`SessionWorkload` object drives the emulator
(:class:`~repro.serving.benchmark.BenchmarkRunner` re-injects follow-ups via
completion callbacks) and the DES baseline
(:class:`~repro.des.simulator.DiscreteEventSimulator`), so emulator-vs-DES
parity extends to closed-loop traffic.

Real-mode caveat: under ``mode="real"`` generated tokens are actual argmax
outputs, not zeros, so precomputed follow-up prompts would diverge from what
a real chat client would send.  Session workloads target the emulated/DES
modes (the paper's sweep regime).

Invariants (the closed-loop release rule): turn ``k+1``'s arrival is
``finish(k) + think``, never earlier; a session's turn count never exceeds
``max_turns`` and its context never exceeds ``max_context_len`` (sessions
end early rather than overflow); ``initial_requests``/``follow_up`` build
*fresh* Request objects per call so one workload object can drive several
runs with byte-identical token streams.

>>> sw = SessionWorkload(SessionConfig(num_sessions=4, qps=2.0,
...                                    turns_mean=2.0, max_turns=3, seed=0))
>>> 0 < sw.num_sessions <= 4
True
>>> sw.total_requests == sum(s.num_turns for s in sw.sessions)
True
>>> first = sw.initial_requests()
>>> all(r.turn_index == 0 for r in first)
True
>>> follow = sw.follow_up(type("Done", (), {
...     "session_id": first[0].session_id, "turn_index": 0,
...     "finish_time": 7.5})())
>>> follow is None or follow.arrival_time >= 7.5
True
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.serving.request import Request

from .arrival import ArrivalProcess, make_arrival
from .synth import lognormal_lengths

__all__ = ["SessionConfig", "TurnSpec", "Session", "SessionWorkload"]

_DUMMY = 0   # emulated output token value (model_runner.DUMMY_TOKEN)


@dataclass(frozen=True)
class SessionConfig:
    num_sessions: int = 16
    qps: float = 1.0                      # session (first-turn) arrival rate
    arrival: str = "poisson"
    arrival_kwargs: Optional[dict] = None
    turns_mean: float = 3.0               # geometric turns/session (mean)
    max_turns: int = 8
    think_time_mean: float = 2.0          # exponential think time (seconds)
    prompt_len_mean: float = 120.0        # first user message (lognormal)
    prompt_len_sigma: float = 0.6
    followup_len_mean: float = 40.0       # later user messages (lognormal)
    followup_len_sigma: float = 0.6
    output_len_mean: float = 60.0
    output_len_sigma: float = 0.6
    min_prompt_len: int = 4
    min_output_len: int = 2
    max_output_len: int = 512
    max_context_len: int = 2048           # session ends before exceeding this
    vocab_size: int = 32000
    shared_prefix_len: int = 0            # cross-session system prompt
    seed: int = 0


@dataclass
class TurnSpec:
    """One pre-sampled conversation turn (tokens fully materialised)."""
    prompt_tokens: List[int]              # full context incl. prior turns
    max_new_tokens: int
    think_time: float                     # delay after previous turn's finish


@dataclass
class Session:
    session_id: int
    arrival_time: float                   # release of turn 0
    turns: List[TurnSpec] = field(default_factory=list)

    @property
    def num_turns(self) -> int:
        return len(self.turns)


class SessionWorkload:
    """Pre-sampled session set + the closed-loop release rule.

    The object is stateless across runs (pure specs): ``initial_requests``
    and ``follow_up`` build fresh :class:`Request` objects every call, so one
    workload can drive an emulator run and a DES run with byte-identical
    token streams.
    """

    def __init__(self, cfg: SessionConfig,
                 arrival: Optional[ArrivalProcess] = None):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        proc = arrival or make_arrival(cfg.arrival, cfg.qps,
                                       **(cfg.arrival_kwargs or {}))
        arrivals = proc.sample(cfg.num_sessions, rng)

        shared = (rng.integers(1, cfg.vocab_size, size=cfg.shared_prefix_len)
                  .tolist() if cfg.shared_prefix_len else [])

        self.sessions: List[Session] = []
        for sid in range(cfg.num_sessions):
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

            sess = Session(session_id=sid,
                           arrival_time=float(arrivals[sid]))
            context: List[int] = list(shared)
            for t in range(n_turns):
                body_len = (max(first_len - len(shared), 1) if t == 0
                            else int(follow_lens[t]))
                if len(context) + body_len > cfg.max_context_len:
                    break                 # context full: session ends early
                body = rng.integers(1, cfg.vocab_size,
                                    size=body_len).tolist()
                prompt = context + body
                out = int(out_lens[t])
                sess.turns.append(TurnSpec(
                    prompt_tokens=prompt,
                    max_new_tokens=out,
                    think_time=0.0 if t == 0 else float(thinks[t]),
                ))
                context = prompt + [_DUMMY] * out
            if sess.turns:
                self.sessions.append(sess)
        # Precomputed id -> list-index map (sessions whose first turn didn't
        # fit max_context_len are dropped, so ids aren't dense).  Built
        # eagerly because follow_up() is called from completion contexts
        # that may run concurrently — engine step threads (thread backend)
        # or per-replica completion-frame reader threads (process backend)
        # — and a lazily-built dict would race its own construction.
        self._id_index = {s.session_id: i
                          for i, s in enumerate(self.sessions)}

    # ---------------------------------------------------------- accounting --
    @property
    def num_sessions(self) -> int:
        return len(self.sessions)

    @property
    def total_requests(self) -> int:
        return sum(s.num_turns for s in self.sessions)

    def session_turns(self, session_id: int) -> int:
        """Turn count of one session (streaming metrics use this to drop
        per-session state the moment its last turn completes)."""
        return self.sessions[self._index_of(session_id)].num_turns

    # ------------------------------------------------------------- release --
    def _request(self, sess: Session, turn: int, arrival: float) -> Request:
        spec = sess.turns[turn]
        return Request(
            prompt_tokens=list(spec.prompt_tokens),
            max_new_tokens=spec.max_new_tokens,
            arrival_time=arrival,
            session_id=sess.session_id,
            turn_index=turn,
        )

    def initial_requests(self) -> List[Request]:
        """Turn 0 of every session (open-loop arrivals); fresh objects."""
        return [self._request(s, 0, s.arrival_time) for s in self.sessions]

    def follow_up(self, finished) -> Optional[Request]:
        """The closed-loop rule: given a *finished* turn (anything exposing
        ``session_id`` / ``turn_index`` / ``finish_time`` — an engine
        :class:`Request`, the unpickled copy a process-mode replica ships
        back in its completion frame, or a DES ``SimRequest``), build the
        next turn with ``arrival = finish + think`` — or None if the
        conversation is over.  Thread-safe (pure reads over pre-sampled
        specs): completion contexts on all backends may call it
        concurrently."""
        sid = getattr(finished, "session_id", None)
        if sid is None:
            return None
        sess = self.sessions[self._index_of(sid)]
        turn = finished.turn_index + 1
        if turn >= sess.num_turns:
            return None
        assert finished.finish_time is not None, "follow_up needs finish_time"
        spec = sess.turns[turn]
        return self._request(sess, turn,
                             finished.finish_time + spec.think_time)

    def _index_of(self, session_id: int) -> int:
        return self._id_index[session_id]
