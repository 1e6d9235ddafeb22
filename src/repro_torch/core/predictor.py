"""Batch descriptors shared by the runners and the runtime predictors.

Only :class:`SeqSpec` and :class:`BatchSpec` are ported so far: the real-mode
runner records one ``(BatchSpec, seconds)`` sample per step, and the
predictors that consume those samples come with the emulator slice.  Both
classes are copies of ``repro.core.predictor``'s, so a real step's
``BatchSpec`` equals the emulator's for the same batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

__all__ = ["SeqSpec", "BatchSpec"]


@dataclass(frozen=True)
class SeqSpec:
    """One sequence's contribution to a step.

    ``new_tokens``  — query tokens processed this step (prefill chunk size,
                      or 1 for decode).
    ``context_len`` — total KV length *after* this step (prompt so far +
                      generated), i.e. what attention reads against.
    ``cached_prefix`` — tokens served from prefix cache (skip compute, still
                      read KV).
    """

    new_tokens: int
    context_len: int
    cached_prefix: int = 0


@dataclass(frozen=True)
class BatchSpec:
    seqs: Tuple[SeqSpec, ...]

    @staticmethod
    def make(seqs: Sequence[SeqSpec]) -> "BatchSpec":
        return BatchSpec(tuple(seqs))

    @property
    def total_new_tokens(self) -> int:
        return sum(s.new_tokens for s in self.seqs)

    @property
    def num_prefill(self) -> int:
        return sum(1 for s in self.seqs if s.new_tokens > 1)

    @property
    def num_decode(self) -> int:
        return sum(1 for s in self.seqs if s.new_tokens == 1)

    @property
    def total_context(self) -> int:
        return sum(s.context_len for s in self.seqs)
