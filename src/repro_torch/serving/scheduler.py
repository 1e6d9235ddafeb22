"""Continuous-batching schedulers.

Two policies reproduce the real-engine behavioural split the paper leans on
(§2.3 "Framework Specificity", §6.2: "SGLang does not perform mixed batching
by default, though it performs chunked prefills"):

* ``vllm``   — Sarathi-style chunked prefill **with mixed batching**: every
  step packs all running decodes (1 token each) plus prefill chunks up to the
  token budget.
* ``sglang`` — chunked prefill with **prefill prioritisation, no mixing**:
  if admissible prefill work exists, the step is prefill-only; otherwise it
  is decode-only.

Shared mechanics: FCFS admission bounded by ``max_num_seqs`` and KV-block
watermark, radix prefix-cache matching on admission, preemption-by-recompute
under memory pressure (newest running request loses, vLLM semantics), and
prefix-cache insert at prefill completion.

The scheduler is pure control-plane: microseconds of CPU per step, no
dependence on GPU values — exactly the property (paper §3.3) that makes
time-warp emulation viable.  The same class runs unmodified in real,
emulated, and sleep modes.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from .kv_cache import BlockManager, OutOfBlocksError
from .prefix_cache import RadixPrefixCache
from .request import Request, RequestState


@dataclass(frozen=True)
class EngineConfig:
    policy: str = "vllm"                  # vllm | sglang
    max_num_seqs: int = 64
    max_batched_tokens: int = 512         # chunk size / step token budget
    block_size: int = 16
    num_blocks: int = 8192
    enable_prefix_caching: bool = True
    host_tier_blocks: int = 0             # hierarchical cache tier (0 = off)
    host_write_policy: str = "write_through"
    # emulated hardware
    chip: str = "tpu-v5e"
    tp: int = 1
    pp: int = 1
    ep: int = 1


@dataclass
class ScheduledSeq:
    request: Request
    num_new_tokens: int                   # prefill chunk size; 1 for decode

    @property
    def is_prefill(self) -> bool:
        return not self.request.prefill_complete


@dataclass
class SchedulerOutput:
    batch: List[ScheduledSeq] = field(default_factory=list)
    preempted: List[Request] = field(default_factory=list)
    admitted: List[Request] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not self.batch

    @property
    def num_tokens(self) -> int:
        return sum(s.num_new_tokens for s in self.batch)


class Scheduler:
    def __init__(self, cfg: EngineConfig, bm: BlockManager,
                 prefix_cache: RadixPrefixCache):
        assert cfg.policy in ("vllm", "sglang"), cfg.policy
        self.cfg = cfg
        self.bm = bm
        self.prefix_cache = prefix_cache
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []     # admission order
        self.num_preemptions = 0

    # ------------------------------------------------------------ intake --
    def add_request(self, req: Request) -> None:
        req.state = RequestState.WAITING
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def num_unfinished(self) -> int:
        return len(self.waiting) + len(self.running)

    # ---------------------------------------------------------- schedule --
    def schedule(self, now: float) -> SchedulerOutput:
        out = SchedulerOutput()
        if self.cfg.policy == "vllm":
            self._schedule_decodes(out, now)
            self._schedule_prefills(out, now,
                                    budget=self.cfg.max_batched_tokens - out.num_tokens)
        else:  # sglang: prefill-prioritised, unmixed
            self._schedule_prefills(out, now, budget=self.cfg.max_batched_tokens)
            if not out.batch:
                self._schedule_decodes(out, now)
        return out

    # ------------------------------------------------- decode scheduling --
    def _schedule_decodes(self, out: SchedulerOutput, now: float) -> None:
        decodes = [r for r in self.running if r.state == RequestState.DECODE]
        for req in list(decodes):
            if req.state != RequestState.DECODE:
                continue  # preempted as a victim earlier in this same step
            while True:
                try:
                    self.bm.append_slot(req)
                    out.batch.append(ScheduledSeq(req, 1))
                    break
                except OutOfBlocksError:
                    # memory pressure: first reclaim cold prefix-cache blocks,
                    # then preempt the newest running request (recompute).
                    if self.prefix_cache.evict(1, now):
                        continue
                    victim = self._pick_victim(exclude=req)
                    if victim is None:
                        # cannot even preempt: victimise this request itself
                        self._preempt(req, out)
                        break
                    self._preempt(victim, out)
            # victim loop may have preempted req itself
            if req.state != RequestState.DECODE:
                continue

    def _pick_victim(self, exclude: Request) -> Optional[Request]:
        for req in reversed(self.running):       # newest first (vLLM)
            if req is not exclude:
                return req
        return None

    def _preempt(self, req: Request, out: SchedulerOutput) -> None:
        self.bm.free_request(req)
        self.running.remove(req)
        req.reset_for_recompute()
        self.waiting.appendleft(req)
        out.preempted.append(req)
        # drop any slot already scheduled for it this step
        out.batch = [s for s in out.batch if s.request is not req]
        self.num_preemptions += 1

    # ------------------------------------------------ prefill scheduling --
    def _schedule_prefills(self, out: SchedulerOutput, now: float,
                           budget: int) -> None:
        # (1) continue running chunked prefills (admission order)
        for req in self.running:
            if budget <= 0:
                return
            if req.state == RequestState.PREFILL:
                chunk = min(budget, req.prompt_len - req.num_prefilled)
                if chunk > 0:
                    out.batch.append(ScheduledSeq(req, chunk))
                    budget -= chunk

        # (2) admit waiting requests FCFS
        while budget > 0 and self.waiting and len(self.running) < self.cfg.max_num_seqs:
            req = self.waiting[0]
            # Prefix-cache match (re-done on each attempt: an eviction retry
            # below may have invalidated a previous match).  Preempted
            # requests recompute from scratch (vLLM recompute semantics).
            cached_blocks: List[int] = []
            n_dev = 0
            if req.num_preemptions == 0 and not req.kv_migrated:
                cached_blocks, n_dev, _n_host = self.prefix_cache.match(
                    req.prompt_tokens, now)
                # never cache-skip the whole prompt: the last token must be
                # recomputed to produce the first output logits
                while cached_blocks and n_dev >= req.prompt_len:
                    cached_blocks = cached_blocks[:-1]
                    n_dev -= self.bm.block_size
            req.cached_prefix_len = n_dev
            if not self.bm.can_admit(req):
                if not self.prefix_cache.evict(
                        self.bm.blocks_needed(
                            req.prompt_len - req.cached_prefix_len), now):
                    break
                continue
            self.waiting.popleft()
            self.bm.allocate_request(req, cached_blocks)
            # PD-migrated KV occupies blocks but needs no recompute: only the
            # final position runs (producing the next token).
            req.num_prefilled = (req.prompt_len - 1 if req.kv_migrated
                                 else req.cached_prefix_len)
            req.state = RequestState.PREFILL
            if req.first_scheduled_time is None:
                req.first_scheduled_time = now
            self.running.append(req)
            out.admitted.append(req)
            chunk = min(budget, req.prompt_len - req.num_prefilled)
            out.batch.append(ScheduledSeq(req, chunk))
            budget -= chunk

    # ------------------------------------------------------- completion --
    def on_step_complete(self, out: SchedulerOutput, token_ids: Dict[int, int],
                         now: float) -> List[Request]:
        """Apply one executed step.  ``token_ids`` maps request_id -> new
        token (only for sequences that produced one: completed-prefill and
        decode).  Returns newly finished requests (already freed)."""
        finished: List[Request] = []
        for sched in out.batch:
            req = sched.request
            if req.state == RequestState.PREFILL:
                req.num_prefilled += sched.num_new_tokens
                if req.prefill_complete:
                    # final chunk produced the first output token
                    req.output_tokens.append(token_ids.get(req.request_id, 0))
                    if req.first_token_time is None:  # preserved across PD handoff
                        req.first_token_time = now
                    req.token_times.append(now)
                    req.state = RequestState.DECODE
                    self._cache_prompt(req, now)
            elif req.state == RequestState.DECODE:
                req.output_tokens.append(token_ids.get(req.request_id, 0))
                req.token_times.append(now)
            if (req.state == RequestState.DECODE
                    and req.num_generated >= req.max_new_tokens):
                req.state = RequestState.FINISHED
                req.finish_time = now
                self.running.remove(req)
                self.bm.free_request(req)
                finished.append(req)
        return finished

    def _cache_prompt(self, req: Request, now: float) -> None:
        if not self.cfg.enable_prefix_caching:
            return
        table = self.bm.block_tables.get(req.request_id, [])
        n_full = req.prompt_len // self.bm.block_size
        self.prefix_cache.insert(
            list(req.prompt_tokens)[: n_full * self.bm.block_size],
            table[:n_full], now)
