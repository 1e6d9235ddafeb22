"""The real model runner: executes the PyTorch model on the card (or on the
CPU when asked).  It is the ground truth that emulation is held against, and
records one ``(BatchSpec, seconds)`` sample per step for fitting a predictor.
It is a module of its own, apart from the emulated runners in
:mod:`repro_torch.serving.model_runner`, because it needs ``torch``.

The real runner does not copy four faults of the reference runner
(``repro.serving.model_runner.RealModelRunner``), and serves two paths that
the reference's raises on or gets wrong:

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
  slot.  Here the runner keeps the KV of the blocks the prefix cache holds
  (:meth:`RealModelRunner.attach_prefix_cache`) and copies a hit's blocks
  into the new slot before its prefill goes on.  A model with recurrent
  layers (SSD, RG-LRU) still raises on a hit: the prefix cache holds no
  state (ROADMAP Queue A item F4).
* P — a resumed preemption re-prefills only its prompt
  (``Request.reset_for_recompute`` keeps the generated tokens), and the
  engine then appends one more output token.  Here the final prompt chunk
  carries the generated tokens after it, so the slot holds the prompt and
  every generated token again and the token returned is the one an
  unpreempted run would have produced next.  ``batch_spec_of`` (a copy of the
  reference's) does not count those tokens.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from repro_torch.core.clock import VirtualClock

from .model_runner import _producing, batch_spec_of
from .scheduler import SchedulerOutput


class RealModelRunner:
    """Executes the PyTorch model — ground truth for fidelity runs.

    A shared slot cache holds ``max_seqs`` rows of ``max_len`` positions (a
    multiple of the model's page size), of recurrent state, or both (a mixed
    stack), and an enc-dec model's cross K/V; it is updated in place.  A
    step runs each prefill chunk on its own slot (batch 1, exact length:
    flash attention, or the recurrence from the slot's carried state), then
    one decode over the slots that decode (paged attention, or the recurrent
    step), then waits for the device; that wall time is the step's real
    duration.

    With prefix caching on, :meth:`attach_prefix_cache` gives the runner the
    engine's block manager and a KV store of ``num_blocks`` blocks a layer,
    indexed by the engine's block ids.  When a request's prompt is complete,
    the KV of its full prompt blocks goes from its slot to the store at its
    table's ids, the blocks the prefix cache then inserts (and pins, so that
    no other request takes them before they are evicted); a hit copies its
    blocks' KV from the store into the new slot.
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
        self.block_manager = None            # the engine's, with prefix caching on
        self._store: Optional[Dict[str, torch.Tensor]] = None   # prefix blocks' KV
        # set to {} to keep the logits (on the device) that each produced
        # token was picked from, by request id, in order: two runs of the
        # same requests can then be held against each other where they part
        self.logits: Optional[Dict[int, List[torch.Tensor]]] = None

    def attach_prefix_cache(self, block_manager) -> None:
        """Serve prefix-cache hits: keep the KV of the engine's blocks, K and
        V of (L, num_blocks, block_size, Hkv, D) in the cache's type (2 GiB
        for llama3_8b at 1024 blocks of 16 positions).  A model with
        recurrent layers gets no store, and a hit raises."""
        self.block_manager = block_manager
        if self.model.recurrent:
            return
        k = self.cache["layers"]["k"]
        shape = (k.shape[0], block_manager.num_blocks, block_manager.block_size) + k.shape[3:]
        self._store = {"k": torch.empty(shape, dtype=k.dtype, device=self.device),
                       "v": torch.empty(shape, dtype=k.dtype, device=self.device)}

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
        if isinstance(layers, list):
            view = [{k: v[slot:slot + 1] for k, v in leaves.items()} for leaves in layers]
        else:
            view = {k: v[:, slot:slot + 1] for k, v in layers.items()}
        out = dict(self.cache, layers=view, cache_len=self.cache["cache_len"][slot:slot + 1])
        for key in ("cross_k", "cross_v"):
            if key in out:
                out[key] = out[key][:, slot:slot + 1]
        return out

    def _reset_slot(self, slot: int) -> None:
        """Empty a slot for a new request.  Attention KV is masked by its
        position tags; a recurrent slot's state and conv state are the
        context itself, and an enc-dec slot's cross K/V the audio, so they
        are zeroed, or the request would inherit them."""
        layers = self.cache["layers"]
        mixed = isinstance(layers, list)           # per-layer (B, ...) leaves
        row = slot if mixed else (slice(None), slot)
        for leaves in layers if mixed else [layers]:
            if "kv_pos" in leaves:
                leaves["kv_pos"][row] = -1
            else:
                leaves["state"][row] = 0
                leaves["conv"][row] = 0
        for key in ("cross_k", "cross_v"):
            if key in self.cache:
                self.cache[key][:, slot] = 0
        self.cache["cache_len"][slot] = 0
        self._slot_len[slot] = 0

    # ------------------------------------------------------- prefix cache --
    def _load_prefix(self, req, slot: int, start: int) -> None:
        """A prefix-cache hit: the KV of the request's first ``start //
        block_size`` blocks, from the store into positions 0 .. start − 1 of
        its (empty) slot."""
        if self._store is None:
            why = ("the model has recurrent layers, whose state the prefix cache "
                   "does not hold" if self.model.recurrent else
                   "the runner holds no prefix KV (attach_prefix_cache was not called)")
            raise NotImplementedError(
                f"request {req.request_id}: a prefix-cache hit of {start} tokens, but "
                f"{why} (ROADMAP Queue A item F4)")
        bs = self.block_manager.block_size
        ids = self.block_manager.block_tables[req.request_id][:start // bs]
        ids_t = torch.tensor(ids, dtype=torch.long, device=self.device)
        layers = self.cache["layers"]
        for key in ("k", "v"):
            blocks = self._store[key][:, ids_t]                  # (L, n, bs, Hkv, D)
            layers[key][:, slot, :start] = blocks.flatten(1, 2)
        layers["kv_pos"][:, slot, :start] = torch.arange(start, dtype=torch.int32,
                                                         device=self.device)
        self.cache["cache_len"][slot] = start
        self._slot_len[slot] = start

    def _save_prefix(self, req, slot: int) -> None:
        """The KV of a completed prompt's full blocks, from its slot into the
        store at its block table's ids; blocks that came from a hit are
        there already."""
        bs = self.block_manager.block_size
        first, n_full = req.cached_prefix_len // bs, req.prompt_len // bs
        if n_full <= first:
            return
        ids = self.block_manager.block_tables[req.request_id][first:n_full]
        ids_t = torch.tensor(ids, dtype=torch.long, device=self.device)
        layers = self.cache["layers"]
        for key in ("k", "v"):
            rows = layers[key][:, slot, first * bs:n_full * bs]
            self._store[key][:, ids_t] = rows.unflatten(1, (n_full - first, bs))

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
                if req.kv_migrated:
                    raise NotImplementedError(
                        f"request {req.request_id} arrives with migrated KV, which "
                        "the real runner does not take")
                slot = self._free_slots.pop()
                self._slot_of[req.request_id] = slot
                self._reset_slot(slot)
                if start > 0:
                    self._load_prefix(req, slot, start)          # F4
            if start != self._slot_len[slot]:
                raise RuntimeError(
                    f"request {req.request_id}: prefill from {start} but its slot "
                    f"holds {self._slot_len[slot]} tokens")
            chunk = list(req.prompt_tokens[start:start + s.num_new_tokens])
            final = start + len(chunk) >= req.prompt_len
            if final:
                chunk += req.output_tokens        # a resumed preemption replays them (P)
            toks = torch.tensor([chunk], dtype=torch.long, device=self.device)
            logits, _ = self.model.prefill(self.params, {"tokens": toks},
                                           self._slot_view(slot))
            self._slot_len[slot] = start + len(chunk)
            if final:
                picked[req.request_id] = torch.argmax(logits[0])
                self._keep(req.request_id, logits[0])
                if self._store is not None:
                    self._save_prefix(req, slot)

        # ---- one decode over the decoding slots only (F2, F3) ----
        if decodes:
            slots, fed, pos = [], [], []
            for s in decodes:
                req = s.request
                slot = self._slot_of[req.request_id]
                p = req.num_prefilled + req.num_generated - 1
                if p != self._slot_len[slot]:
                    raise RuntimeError(
                        f"request {req.request_id} decodes at position {p} but its "
                        f"slot holds {self._slot_len[slot]} tokens")
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
                self._keep(s.request.request_id, logits[i])

        self._sync()
        dt = time.monotonic() - t0
        self.samples.append((batch_spec_of(out), dt))
        ids = list(picked)
        values = torch.stack([picked[i] for i in ids]).tolist() if ids else []
        return dict(zip(ids, values))

    def _keep(self, request_id: int, row) -> None:
        if self.logits is not None:
            self.logits.setdefault(request_id, []).append(row)

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
