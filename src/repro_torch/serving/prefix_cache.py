"""Radix-tree prefix cache with hierarchical tiers.

Device tier: a radix tree over block-granular token chunks whose leaves pin
KV blocks in the :class:`BlockManager`.  A lookup returns the longest cached
prefix (whole blocks); matched blocks are refcounted into the requesting
sequence's block table instead of recomputing their KV.

Hierarchical tier (paper §2.3): a host-memory tier with **two write
policies**, reproducing the semantic divergence the paper calls out between
the engines:

* ``write_through`` (vLLM + LMCache): every block inserted into the device
  tier is immediately copied to the host tier.
* ``write_through_selective`` (SGLang): a block is copied to the host tier
  only upon its *first cache hit* (asynchronously in the real system; we
  charge the copy at hit time).

On a device-tier miss that hits the host tier, blocks are restored (the
engine charges the H2D transfer duration via its predictor).  Eviction is
LRU over unpinned leaves in virtual time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .kv_cache import BlockManager


@dataclass
class _Node:
    chunk: Tuple[int, ...]                    # block_size token ids
    block_id: Optional[int]                   # device block (None = evicted)
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)
    parent: Optional["_Node"] = None
    last_access: float = 0.0
    pinned: int = 0                           # outstanding matched requests


@dataclass
class PrefixCacheStats:
    lookups: int = 0
    hit_tokens: int = 0
    query_tokens: int = 0
    device_hits: int = 0
    host_hits: int = 0
    evictions: int = 0
    host_evictions: int = 0
    inserts: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.query_tokens if self.query_tokens else 0.0


class RadixPrefixCache:
    def __init__(
        self,
        block_manager: BlockManager,
        *,
        enable: bool = True,
        host_tier_blocks: int = 0,                 # 0 = no hierarchical tier
        host_write_policy: str = "write_through",  # | write_through_selective
    ):
        self.bm = block_manager
        self.enable = enable
        self.block_size = block_manager.block_size
        self.root = _Node(chunk=(), block_id=None)
        self._nodes_by_block: Dict[int, _Node] = {}
        self.host_tier_blocks = host_tier_blocks
        self.host_write_policy = host_write_policy
        self._host: Dict[Tuple[Tuple[int, ...], ...], float] = {}  # path -> last access
        self.stats = PrefixCacheStats()

    # -------------------------------------------------------------- match --
    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n_full = len(tokens) // bs
        return [tuple(tokens[i * bs : (i + 1) * bs]) for i in range(n_full)]

    def match(self, tokens: Sequence[int], now: float) -> Tuple[List[int], int, int]:
        """Longest-prefix match.  Returns (device_block_ids, n_device_tokens,
        n_host_tokens).  Matched device blocks are pinned (caller must
        release via :meth:`release` when the request frees its table —
        the BlockManager refcount handles that automatically since the
        blocks enter the request's block table)."""
        if not self.enable:
            return [], 0, 0
        self.stats.lookups += 1
        self.stats.query_tokens += len(tokens)
        node = self.root
        blocks: List[int] = []
        path: List[Tuple[int, ...]] = []
        host_tokens = 0
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None or child.block_id is None:
                # device miss: consult host tier for the extended path
                if self.host_tier_blocks:
                    cand = tuple(path + [chunk])
                    if cand in self._host:
                        self._host[cand] = now
                        host_tokens += self.block_size
                        self.stats.host_hits += 1
                        path.append(chunk)
                        # (engine restores the block + charges transfer time)
                        continue
                break
            node = child
            node.last_access = now
            blocks.append(node.block_id)
            path.append(chunk)
            self.stats.device_hits += 1
            # SGLang-style: first hit promotes the block to the host tier
            if (self.host_tier_blocks
                    and self.host_write_policy == "write_through_selective"):
                self._host_insert(tuple(path), now)
        self.stats.hit_tokens += len(blocks) * self.block_size + host_tokens
        return blocks, len(blocks) * self.block_size, host_tokens

    def probe(self, tokens: Sequence[int]) -> int:
        """Read-only longest-prefix probe: returns the number of device-tier
        cached tokens without touching stats, LRU timestamps, pins, or the
        host tier.  Safe to call concurrently with engine mutation (chunk
        lookups are dict ``get``s under the GIL); routers use it to score
        prefix affinity without perturbing cache behaviour."""
        if not self.enable:
            return 0
        node = self.root
        n_tokens = 0
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None or child.block_id is None:
                break
            node = child
            n_tokens += self.block_size
        return n_tokens

    # -------------------------------------------------------------- insert --
    def insert(self, tokens: Sequence[int], block_ids: Sequence[int],
               now: float) -> None:
        """Register a computed sequence's blocks (called when a prefill
        completes).  Each block gets one cache reference (pin)."""
        if not self.enable:
            return
        node = self.root
        path: List[Tuple[int, ...]] = []
        for chunk, bid in zip(self._chunks(tokens), block_ids):
            path.append(chunk)
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk=chunk, block_id=bid, parent=node,
                              last_access=now)
                node.children[chunk] = child
                self.bm.pin(bid)
                self._nodes_by_block[bid] = child
                self.bm.set_block_tokens(bid, chunk)
                self.stats.inserts += 1
                if (self.host_tier_blocks
                        and self.host_write_policy == "write_through"):
                    self._host_insert(tuple(path), now)
            elif child.block_id is None:
                child.block_id = bid
                self.bm.pin(bid)
                self._nodes_by_block[bid] = child
                child.last_access = now
            else:
                child.last_access = now
            node = child

    def restore_from_host(self, tokens: Sequence[int], block_ids: Sequence[int],
                          now: float) -> None:
        """Host-tier blocks recomputed into fresh device blocks get
        re-registered in the device tree."""
        self.insert(tokens, block_ids, now)

    # ------------------------------------------------------------- evict --
    def evict(self, n_blocks: int, now: float) -> int:
        """Free up to ``n_blocks`` LRU unpinned leaves; returns count."""
        freed = 0
        while freed < n_blocks:
            victim = self._lru_leaf()
            if victim is None:
                break
            bid = victim.block_id
            victim.block_id = None
            self._nodes_by_block.pop(bid, None)
            if not victim.children and victim.parent is not None:
                victim.parent.children.pop(victim.chunk, None)
            self.bm.unpin(bid)
            self.stats.evictions += 1
            freed += 1
        return freed

    def evict_to_watermark(self, now: float) -> int:
        need = self.bm.watermark_blocks - self.bm.num_free
        return self.evict(need, now) if need > 0 else 0

    def _lru_leaf(self) -> Optional[_Node]:
        best: Optional[_Node] = None
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self.root or node.block_id is None:
                continue
            has_live_child = any(c.block_id is not None for c in node.children.values())
            if has_live_child:
                continue
            if best is None or node.last_access < best.last_access:
                best = node
        return best

    # --------------------------------------------------------- host tier --
    def _host_insert(self, path: Tuple[Tuple[int, ...], ...], now: float) -> None:
        if path in self._host:
            self._host[path] = now
            return
        if len(self._host) >= self.host_tier_blocks:
            victim = min(self._host, key=self._host.get)
            del self._host[victim]
            self.stats.host_evictions += 1
        self._host[path] = now

    # ---------------------------------------------------------- counters --
    def num_cached_blocks(self) -> int:
        return len(self._nodes_by_block)
