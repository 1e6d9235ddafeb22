"""Paged KV-cache block manager (vLLM-style), engine control-plane state.

This is *metadata* in the paper's split-state memory model: block tables,
refcounts and free lists are small, faithfully-executed host state (the
emulated compute buffers backing the actual KV pool live in the
VirtualDeviceContext).  The manager supports:

* block allocation/free with refcounting (copy-on-write prefix sharing),
* watermark-based admission (reserve headroom so running decodes don't
  immediately re-preempt),
* integration hooks for the radix prefix cache (cached blocks enter a
  request's table with an extra ref instead of being recomputed).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .request import Request


class OutOfBlocksError(RuntimeError):
    pass


@dataclass
class Block:
    block_id: int
    ref_count: int = 0
    # token ids stored in this block (control metadata; enables prefix reuse)
    token_ids: tuple = ()


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int, *,
                 watermark_frac: float = 0.01):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.watermark_blocks = max(1, int(num_blocks * watermark_frac))
        self._blocks = [Block(i) for i in range(num_blocks)]
        self._free: set[int] = set(range(num_blocks))
        self.block_tables: Dict[int, List[int]] = {}

    # ----------------------------------------------------------- queries --
    @property
    def num_free(self) -> int:
        return len(self._free)

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def can_admit(self, req: Request) -> bool:
        """Admission check for a WAITING/PREEMPTED request: must fit its
        prompt (minus cached prefix) plus watermark headroom."""
        need = self.blocks_needed(req.prompt_len - req.cached_prefix_len)
        return self.num_free - need >= self.watermark_blocks

    def can_append(self, n_blocks: int = 1) -> bool:
        return self.num_free >= n_blocks

    # --------------------------------------------------------- mutations --
    def _take(self) -> Block:
        if not self._free:
            raise OutOfBlocksError("KV pool exhausted")
        b = self._blocks[self._free.pop()]  # arbitrary free block
        assert b.ref_count == 0
        b.ref_count = 1
        b.token_ids = ()
        return b

    def allocate_request(self, req: Request,
                         cached_blocks: Optional[List[int]] = None) -> None:
        """Create a block table: referenced prefix-cache blocks + fresh
        blocks for the uncached remainder of the prompt."""
        assert req.request_id not in self.block_tables
        table: List[int] = []
        if cached_blocks:
            for bid in cached_blocks:
                self._blocks[bid].ref_count += 1
                table.append(bid)
        uncached = req.prompt_len - len(table) * self.block_size
        for _ in range(self.blocks_needed(max(uncached, 0))):
            table.append(self._take().block_id)
        self.block_tables[req.request_id] = table

    def append_slot(self, req: Request) -> None:
        """Ensure capacity for one more token (decode step)."""
        table = self.block_tables[req.request_id]
        if req.context_len + 1 > len(table) * self.block_size:
            table.append(self._take().block_id)

    def free_request(self, req: Request) -> List[int]:
        """Drop the request's references; returns block ids that hit ref 0
        (the prefix cache may resurrect them before they're reused)."""
        table = self.block_tables.pop(req.request_id, [])
        released = []
        for bid in table:
            b = self._blocks[bid]
            b.ref_count -= 1
            assert b.ref_count >= 0
            if b.ref_count == 0:
                self._free.add(bid)
                released.append(bid)
        return released

    # --------------------------------------------- prefix-cache interface --
    def pin(self, bid: int) -> None:
        b = self._blocks[bid]
        if b.ref_count == 0 and bid in self._free:
            self._free.discard(bid)  # resurrect from free list (O(1))
        b.ref_count += 1

    def unpin(self, bid: int) -> None:
        b = self._blocks[bid]
        b.ref_count -= 1
        assert b.ref_count >= 0
        if b.ref_count == 0:
            self._free.add(bid)

    def set_block_tokens(self, bid: int, token_ids: tuple) -> None:
        self._blocks[bid].token_ids = token_ids

    def utilization(self) -> float:
        return 1.0 - self.num_free / self.num_blocks
