"""Request lifecycle: the unit of work the serving engine schedules.

The state machine mirrors vLLM's sequence states; all timestamps are
*virtual* seconds (Observers read the shared clock).  Generation lengths are
fixed by the workload, not by EOS sampling — the paper's footnote 1: standard
practice for performance modeling, and what keeps the control plane
independent of GPU *values*.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

_req_counter = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"          # running, prompt not fully processed
    DECODE = "decode"            # running, generating
    PREEMPTED = "preempted"      # evicted under memory pressure; recompute
    FINISHED = "finished"


@dataclass
class Request:
    prompt_tokens: Sequence[int]
    max_new_tokens: int
    arrival_time: float = 0.0
    request_id: int = field(default_factory=lambda: next(_req_counter))

    # closed-loop session identity (repro.workload.session): follow-up turns
    # are re-injected on completion and carry the prior turn's tokens
    session_id: Optional[int] = None
    turn_index: int = 0

    # fleet-plane identity (repro.fleet): the tenant the ingress assigned
    # this request to, and the LoRA adapter it must be served with (None =
    # base model).  Routing keys only — the engine never branches on them.
    tenant: Optional[str] = None
    adapter: Optional[str] = None

    # progress
    state: RequestState = RequestState.WAITING
    num_prefilled: int = 0            # prompt tokens processed so far
    output_tokens: List[int] = field(default_factory=list)
    cached_prefix_len: int = 0        # served from prefix cache (skip compute)

    # measurements (virtual time)
    first_scheduled_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    num_preemptions: int = 0
    kv_transfer_time: float = 0.0     # PD disaggregation accounting
    kv_migrated: bool = False         # KV arrived via PD transfer: skip compute

    # ------------------------------------------------------------ derived --
    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)

    @property
    def num_generated(self) -> int:
        return len(self.output_tokens)

    @property
    def prefill_complete(self) -> bool:
        return self.num_prefilled >= self.prompt_len

    @property
    def context_len(self) -> int:
        """Tokens currently represented in the KV cache / recurrent state."""
        return self.num_prefilled + self.num_generated

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens

    @property
    def finished(self) -> bool:
        return self.state == RequestState.FINISHED

    # ------------------------------------------------------------ metrics --
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        n = self.num_generated - 1
        if n <= 0:
            return 0.0
        return (self.finish_time - self.first_token_time) / n

    def e2e_latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    def reset_for_requeue(self) -> None:
        """Crash recovery (fault injection): the replica — and every byte of
        its KV/prefix state — is gone.  The request re-enters routing as if
        freshly arrived: identity and the *original* arrival time are kept
        (TTFT keeps measuring from first submission, so a crash costs
        latency, never erases it), all progress and measurements zero."""
        self.output_tokens = []
        self.num_prefilled = 0
        self.cached_prefix_len = 0
        self.first_scheduled_time = None
        self.first_token_time = None
        self.finish_time = None
        self.token_times = []
        self.kv_migrated = False
        self.state = RequestState.WAITING

    def reset_for_recompute(self) -> None:
        """Preemption-by-recompute: KV is dropped; prompt + generated tokens
        are replayed as a (longer) prefill on resume."""
        self.num_preemptions += 1
        self.num_prefilled = 0
        self.cached_prefix_len = 0
        self.state = RequestState.PREEMPTED
