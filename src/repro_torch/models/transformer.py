"""Decoder LMs and the encoder-decoder in PyTorch: the paths of
``repro.models.transformer.TransformerLM`` (dense, dropless MoE, sliding
window, prepended frontend embeddings; Mamba2's SSD; RecurrentGemma's mixed
RG-LRU and local-attention pattern) and of ``EncDecLM`` (Whisper).

Entry points, as in the reference:

* ``prefill(params, inputs, cache)``  — process T new tokens per sequence
  against the cache; returns the last position's logits.
* ``decode_step(params, cache, tokens)`` — the T = 1 case.
* ``decode_slots(params, cache, tokens, slots)`` — T = 1 for the listed cache
  rows only; no other row is read or written.  The serving runner decodes
  the sequences of a step this way, so a slot that is mid-prefill is never
  touched by another request's decode.

Parameters are nested dictionaries of tensors with the JAX names and layouts.
A uniform layer pattern stacks its blocks on a leading layer axis; a mixed
one (RecurrentGemma) keeps a list of per-layer blocks and caches, as the
reference's unrolled stack does.  The cache keeps the reference's layout:
for attention (``attn``, ``local_attn``) ``k``/``v`` (L, B, S, Hkv, D) and
``kv_pos`` (L, B, S) filled with −1; for SSD the fp32 recurrent ``state``
(L, B, H, N, P) and ``conv`` state (L, B, K−1, d_inner + 2N); for RG-LRU the
fp32 ``state`` (L, B, W) and ``conv`` state (L, B, K−1, W), whatever the
cache's type; and ``cache_len`` (B,).  **The cache is updated in place**:
``prefill`` and the decodes write the new K/V or states, positions and
lengths into the tensors they were given and return that same cache.

Attention over the cache goes through :mod:`repro_torch.kernels.ops`:

* T > 1: flash attention (K1) over ``k[:, :cache_len + T]``; the queries are
  the last T of those keys, K1's bottom-right alignment.  The rows of a batch
  must share one ``cache_len``.
* T = 1: paged attention (K2) reads the slot cache as pages: a row of S
  positions is S / PAGE_SIZE consecutive pages, so row b's block table is
  ``b * S / PAGE_SIZE + arange(S / PAGE_SIZE)`` and its context length is
  position + 1.  The pages are a view of the cache, not a copy.

A sliding window (``cfg.sliding_window``, on every attention layer, as in
the reference) goes to both kernels, which mask by position: a query at p
sees the keys at p − window + 1 .. p.  A windowed layer keeps the
reference's ring of min(cache_size, window) + ``window_slack`` positions a
row (:func:`cache_span`), position p at p % S.  A prefill chunk that ends
past S attends over the ring's earlier keys and its own before it writes
(:func:`_prefill_segments`); a decode reads the ring through modular block
tables (:func:`_page_tables`).

Given a rank's blocks of the parameters (``launch.mesh.shard_params``,
under an ambient mesh of more than one "model" rank: ``layers.use_mesh``),
the model runs on them: its attention heads (or, where the heads do not
split, its block of head_dim), MLP width, RG-LRU width, SSD heads (K3 on
the rank's heads), experts or experts' FFN width, and vocabulary rows,
Megatron's tensor parallelism in :mod:`.layers`.  ``init_cache`` given
those parameters holds their blocks: KV heads or head_dim, the RG-LRU
states' width, the SSD state's heads and the conv state's channels.  K1
and K2 run on the rank's query heads (every one where the query heads do
not split), over K/V gathered to whole heads where the cache holds a block
of head_dim (``layers.AttnHeads``): each prefill chunk's keys and its
cached prefix, each decode's live rows (:func:`_decode_view`), the
encoder-decoder's cross cache alike.

Under a mesh with batch axes ("data", or "pod" and "data"; the serve
rules' placement of a decode cell), ``init_cache`` holds the rank's blocks
of the cache rules (``launch.mesh.shard_cache``).  Where the batch axes
divide the batch, those are its rows: the caller gives the rank its rows'
tokens, and it prefills and decodes them as one process does; the MoE's
experts, whose d the rank holds a block of, are gathered over the batch
axes where they run (``layers.gather_experts``).  Where they do not divide
it (``long_500k``: one row), each "data" rank holds a contiguous block of
every attention layer's KV slots (:class:`SeqBlock`; the recurrent states
whole), and every rank is given every row: a prefill attends as one
process does and writes only its block's slots (:func:`_block_prefill`); a
decode writes the token where its block holds slot p % S, runs K2 over
each run of its block that the query sees (:func:`block_runs`: a ring's
block may hold two) with their lse, and the ranks' attention is merged
over "data" (:func:`_block_decode`, ``layers.merge_blocks``).  An
encoder-decoder's cross cache is cut on its frames the same way, at the
reference's frame count (whisper's 1500 give 375 a rank over 4, stored in
384 slots, the pad after them): every rank encodes every frame and keeps
its block, and a decode runs K2 over the block's frames and merges
(:func:`_block_cross`).  Under the deferred
append a decode reads its block of the cache before the token
(``block_runs(..., deferred=True)``), the token's own key is counted on the
rank whose block holds its slot, and that rank alone writes it after the
layers.  ``init_cache(..., seq_shard=True)`` is the reference's
``kv_seq_shard`` opt: where the batch axes divide the batch, each "model"
rank holds its block of the slots (and of the frames) of every KV head
whole; a decode gathers the ranks' query heads to every head and the
token's k, v to whole heads, runs K2 for every head over its block and
merges over "model", keeping its own query heads (the same functions,
over the block's axis).

An MoE block (``cfg.moe``) replaces the MLP with :func:`layers.moe`, or
with :func:`layers.moe_a2a` where ``cfg.moe_impl == "a2a"`` (expert
parallelism over the ambient mesh's "model" ranks, each rank running the
whole model on the same tokens with its own experts; the dropless MoE
without a mesh); its auxiliary outputs are dropped, as serving does in the
reference.  A
``frontend`` config takes ``inputs["frontend_embeds"]`` (B, F, d), which
are prepended to the token embeddings: that prefill writes F + T positions.

An SSD block's prefill runs its chunked scan through ``ops.ssd_scan`` (K3 on
the card) from the rows' carried states, at any T; its decode is plain
PyTorch, as in the reference.  An RG-LRU block runs its recurrence in plain
PyTorch (:func:`layers.rglru`).  A recurrent state has no position mask, so
a decode reads and writes the state rows of the listed slots and no others.

:class:`EncDecLM` runs the encoder's bidirectional self-attention through K1
with ``causal=False``, and the decoder's cross-attention through K1 with
``causal=False`` (T > 1) or through K2 over the slot's cross cache (T = 1),
which is padded to a whole number of pages; its context length is F.

``kv_append="defer"`` (the reference's ``_apply_deferred_append``) leaves
the cache unwritten while the layers run.  Each attention layer attends over
two segments and merges them exactly (:func:`layers.attention_merge`):

* prefill: the cached keys ``k[:, :s0]`` through K1 with ``q_offset = s0``
  (the causal mask is vacuous there, the window is not), skipped for the
  first chunk; and the new chunk's own keys through K1, causal from 0;
* decode: the cached keys through K2 with ``context_lens = pos`` and the
  window less one (the new token is not in the cache; skipped at a window of
  1), and the new token's own key, whose output is its value and whose
  log-sum-exp is its one scaled score.

After the last layer a uniform stack writes every layer's new K/V and
``kv_pos`` into the (L, B, S, ...) cache in one ``index_put_``; a mixed
stack (RecurrentGemma) writes each layer's right after it, as the
reference's unrolled stack does; a rank that holds a block of the slots
writes only the positions its block holds.  The encoder-decoder keeps the
inline append, as the reference's ``EncDecLM`` does.

Training (``train_loss``, as the reference's) runs every block without a
cache (:func:`_train_block`, which :func:`run_block` also runs given
``cache=None``): attention over the T positions of the batch through
``ops.flash_attention``, causal from 0 with the config's window (no mask
for the encoder and the cross-attention), which on the card is K1 forward
and K1's gradient kernel backward; SSD, RG-LRU and MoE blocks as in a
prefill from a zero state, the SSD scan through ``ops.ssd_scan``, which on
the card is K3 forward and K3's gradient kernel backward.  ``remat`` wraps
each block in ``torch.utils.checkpoint`` (so K3's forward runs twice a
layer and its gradient once).  Every architecture trains on the CPU and on
the card, and on a training mesh's ranks: the encoder-decoder's embedding
and logits vocabulary-parallel, its encoder's and cross attention's
leaves gathered over "data" where they are used.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops

from . import layers as L
from .config import ModelConfig

PAGE_SIZE = 16     # K2's view of a slot: S / PAGE_SIZE consecutive pages

ATTN_KINDS = ("attn", "local_attn")
RECURRENT_KINDS = ("ssd", "rglru")

MOE_IMPLS = ("ragged", "a2a")


def whole_pages(n: int) -> int:
    """The slots that hold ``n`` positions or frames in whole pages of K2,
    the pad after them (whisper's 1500 frames in 1504, 375 in 384)."""
    return -(-n // PAGE_SIZE) * PAGE_SIZE


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a value of ``cfg`` the port does not know."""
    for kind in cfg.layer_pattern:
        if kind not in ATTN_KINDS + RECURRENT_KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
    if cfg.kv_append not in ("inline", "defer"):
        raise ValueError(f"unknown kv_append {cfg.kv_append!r}")
    if cfg.moe is not None and cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")


def _moe_fn(cfg: ModelConfig):
    """The MoE block's function: the expert-parallel one for ``a2a``."""
    return L.moe_a2a if cfg.moe_impl == "a2a" else L.moe


# ==========================================================================
# per-block parameter init / apply
# ==========================================================================

def block_params(cfg: ModelConfig, kind: str, generator: torch.Generator, dtype,
                 device=None, lead=()) -> Dict:
    """One block's parameters; ``lead=(L,)`` stacks L blocks on axis 0.  An
    SSD block has one pre-norm and no MLP; an RG-LRU block has the
    recurrence where an attention block has ``attn``; an MoE config's
    attention block has ``moe`` where a dense one has ``mlp``."""
    if kind == "ssd":
        return {"norm1": L.norm_params(cfg, dtype, device, lead),
                "ssd": L.ssd_params(cfg, generator, dtype, device, lead)}
    if kind == "rglru":
        return {"norm1": L.norm_params(cfg, dtype, device, lead),
                "rglru": L.rglru_params(cfg, generator, dtype, device, lead),
                "norm2": L.norm_params(cfg, dtype, device, lead),
                "mlp": L.mlp_params(cfg, generator, dtype, device, lead=lead)}
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    p = {
        "norm1": L.norm_params(cfg, dtype, device, lead),
        "attn": L.attn_params(cfg, generator, dtype, device, lead),
        "norm2": L.norm_params(cfg, dtype, device, lead),
    }
    if cfg.moe is not None:
        p["moe"] = L.moe_params(cfg, generator, dtype, device, lead)
    else:
        p["mlp"] = L.mlp_params(cfg, generator, dtype, device, lead=lead)
    return p


def cache_span(cfg: ModelConfig, kind: str, cache_size: int, window_slack: int = 0) -> int:
    """Positions a row of an attention layer's cache holds, as the
    reference's ``_cache_span``: a windowed layer (``local_attn`` or
    ``attn`` under ``cfg.sliding_window``, the window of both) keeps a ring
    of min(cache_size, window) + ``window_slack``; any other layer keeps
    ``cache_size`` (the reference adds the slack there too, where a row
    never wraps, and cannot build a ``local_attn`` layer without a window,
    which here attends over the whole row).  Raises unless the span is a
    whole number of K2's pages."""
    if kind in ATTN_KINDS and cfg.sliding_window:
        span = min(cache_size, cfg.sliding_window) + window_slack
    else:
        span = cache_size
    if span % PAGE_SIZE:
        raise ValueError(f"a {kind} cache row of {span} positions is not a multiple of the "
                         f"page size {PAGE_SIZE}")
    return span


def block_cache(cfg: ModelConfig, kind: str, batch: int, cache_size: int, dtype,
                device=None, lead=(), window_slack: int = 0, p: Optional[Dict] = None
                ) -> Dict:
    """Cache leaves of one block; ``lead=(L,)`` stacks L blocks on axis 0.
    An attention block's rows hold :func:`cache_span` positions of its KV
    heads, an RG-LRU block's states its width, an SSD block's state its
    heads and its conv state its conv channels: the config's, or those of
    the block's parameters ``p`` where given (a tensor-parallel rank's
    blocks: its KV heads or its block of head_dim, its block of the width;
    an SSD rank's H/tp heads and its block of the d_inner + 2N channels,
    tp being how many blocks of ``w_in`` make the whole).  SSD and RG-LRU
    states are fp32 whatever ``dtype`` is, and take no ``cache_size``."""
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "ssd":
        ssm = cfg.ssm
        d_in, H = ssm.d_inner(cfg.d_model), ssm.num_heads(cfg.d_model)
        channels = d_in + 2 * ssm.state_dim
        tp = 1 if p is None else (d_in + channels + H) // p["ssd"]["w_in"].shape[-1]
        lead = tuple(lead) + (batch,)
        return {"state": torch.zeros(lead + (H // tp, ssm.state_dim, ssm.head_dim), **f32),
                "conv": torch.zeros(lead + (ssm.conv_width - 1, channels // tp), **f32)}
    if kind == "rglru":
        rg = cfg.rglru
        width = rg.lru_width if p is None else p["rglru"]["w_x"].shape[-1]
        lead = tuple(lead) + (batch,)
        return {"state": torch.zeros(lead + (width,), **f32),
                "conv": torch.zeros(lead + (rg.conv_width - 1, width), **f32)}
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    heads = (cfg.num_kv_heads, cfg.head_dim) if p is None else tuple(p["attn"]["wk"].shape[-2:])
    shape = tuple(lead) + (batch, cache_span(cfg, kind, cache_size, window_slack)) + heads
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kv_pos": torch.full(shape[:-2], -1, dtype=torch.int32, device=device)}


@dataclass(frozen=True)
class SeqBlock:
    """A serving rank's block of every attention layer's KV sequence (or
    of an encoder-decoder's cross cache's frames): positions [lo, hi) of
    each row's ``whole`` (a ring's or a linear row's S slots, or the F real
    frames), block ``index`` of ``count`` over ``axis``, as the cache rules
    place k, v and kv_pos: over "data" where the batch axes do not divide
    the batch (context-parallel decode), over "model" under
    ``kv_seq_shard`` where they do.  The rank stores its ``span``
    positions in ``size`` slots, whole pages of K2, the pad after them and
    never read: none for the KV sequence, whose blocks must be whole pages;
    a block of whisper's 1500 frames over 4 ranks holds 375 in 384 slots.
    ``init_cache`` keeps it in the cache under "seq_block" (the cross
    cache's under "cross_block"), a leaf that is not a tensor."""

    index: int
    count: int
    whole: int
    axis: str = "data"

    @property
    def span(self) -> int:
        return self.whole // self.count

    @property
    def size(self) -> int:
        return whole_pages(self.span)

    @property
    def lo(self) -> int:
        return self.index * self.span

    @property
    def hi(self) -> int:
        return self.lo + self.span


def block_runs(positions, block: SeqBlock, window: Optional[int], deferred: bool = False):
    """K2's launches for a decode of queries at ``positions`` (host ints,
    one a row, each written at slot p % S before the attention) over the
    slots [lo, hi) of ``block``: [(the rows' indices, each row's first page
    counted from lo, its context length, the window)], one launch each.

    ``deferred`` (``kv_append="defer"``): the token is not written before
    the attention, so its slot still holds p − S (a wrapped ring) or
    nothing (a linear row), and the cache's keys a query at p sees are
    p − window + 1 .. p − 1 (all of 0 .. p − 1 without a window): those a
    query at p − 1 with the window less one sees of a cache written up to
    p − 1, which is what the runs are then counted for.  A query at 0, or
    under a window of 1, sees no key of the cache.

    Slot s holds the newest position p − ((p − s) mod S) ≤ p (negative:
    not written yet), so the block is at most two runs of consecutive
    positions, split at the query's slot r = p % S:

    * slots lo .. r, where r lies in the block: positions p − (r − lo) ..
      p, which end at the query: K2 as one process runs it, context length
      r − lo + 1, the window itself;
    * slots a .. hi − 1 with a = r + 1 (lo where r is not in the block),
      where they hold written positions: their last, x = p − ((p − hi + 1)
      mod S), lies g = p − x before the query, so K2 (whose query sits at
      its last key) runs with the window less g, which masks what lies
      before p − window + 1; a run that starts inside a page starts at
      that page, whose slots before a hold newer positions (the first run)
      and lie before the window, since S ≥ window wherever a row wraps.
      A run wholly before the window is no launch.

    Rows with the same run and window share a launch; a row of no run
    sees no key here (its block's lse is -inf)."""
    groups: Dict[Tuple[str, Optional[int]], List[Tuple[int, int, int]]] = {}
    S, lo, hi = block.whole, block.lo, block.hi
    if deferred:
        if window == 1:
            return []
        positions = [p - 1 for p in positions]
        window = None if window is None else window - 1
    for i, p in enumerate(positions):
        if p < 0:
            continue
        r = p % S
        if lo <= r < hi:
            groups.setdefault(("own", window), []).append((i, 0, r - lo + 1))
        a = r + 1 if lo <= r < hi else lo
        x = p - ((p - hi + 1) % S)
        if a >= hi or x < 0:
            continue
        w = None if window is None else window - (p - x)
        if w is not None and w <= 0:
            continue
        first = (a - lo) // PAGE_SIZE
        groups.setdefault(("older", w), []).append((i, first, hi - lo - first * PAGE_SIZE))
    return [([e[0] for e in run], [e[1] for e in run], [e[2] for e in run], w)
            for (_, w), run in groups.items()]


def _block_group(block: SeqBlock):
    """The ambient mesh's group of ``block.axis``, whose ranks hold
    ``block``'s siblings; raises unless this rank's coordinate on it is its
    index."""
    mesh = L.ambient_mesh()
    if L.axis_coordinate(mesh, block.axis) != (block.index, block.count):
        raise ValueError(f"the cache holds block {block.index} of {block.count} of the KV "
                         f"sequence over {block.axis!r}; the ambient mesh gives this rank "
                         f"{L.axis_coordinate(mesh, block.axis)}")
    return mesh.get_group(block.axis)


def _merged(block: SeqBlock, out, lse):
    """The ranks' attention over their blocks merged over ``block.axis``
    (``layers.merge_blocks``): counted as "merge" over "data", as
    "seq_shard" over "model"."""
    return L.merge_blocks(out, lse, _block_group(block),
                          "merge" if block.axis == "data" else "seq_shard")


def _gather_blocks(block: SeqBlock, leaves: Dict) -> Dict:
    """Whole rows of a rank's blocks of cache leaves (.., B, block.size, ..):
    each block's ``span`` positions, its pad dropped, gathered over
    ``block.axis`` on the slot dimension in order
    (``GATHERED["kv_prefix"]``, the bytes gathered)."""
    group = _block_group(block)
    whole = {}
    for name, t in leaves.items():
        dim = t.dim() - (1 if name == "kv_pos" else 3)
        if block.span != t.shape[dim]:
            t = t.narrow(dim, 0, block.span)
        L.GATHERED["kv_prefix"] += t.numel() * t.element_size() * (block.count - 1)
        whole[name] = L._all_gather(t, dim, group)
    return whole


@dataclass
class CacheStep:
    """Where one forward's tokens go in the cache, worked out once for all
    layers.  Attention prefill (T > 1) sets ``start``; decode (T = 1) sets
    ``rows`` (and, for attention, the rest); SSD prefill sets nothing."""

    start: Optional[int] = None                  # first position of every row
    rows: Optional[torch.Tensor] = None          # (n,) cache rows decoded
    block_tables: Optional[torch.Tensor] = None  # (n, S / PAGE_SIZE [+ 1]) int32
    context_lens: Optional[torch.Tensor] = None  # (n,) int32
    cross_tables: Optional[torch.Tensor] = None  # (n, F_pad / PAGE_SIZE) int32, enc-dec
    cross_lens: Optional[torch.Tensor] = None    # (n,) int32: F, enc-dec
    live: Optional[int] = None                   # positions a decode gathers (_decode_view)
    block: Optional[SeqBlock] = None             # the rank's block of the KV sequence
    runs: Optional[List] = None                  # a decode's K2 launches over it (block_runs)
    at: Optional[List[int]] = None               # a decode's positions, where given on the host


def run_block(cfg: ModelConfig, kind: str, p: Dict, x, positions, cache: Optional[Dict],
              *, step: CacheStep, force: Optional[str] = None,
              cross: Optional[Tuple[Dict, Dict]] = None, deferred: Optional[List] = None):
    """One residual block over its layer's cache (updated in place).

    x: (n, T, d); positions: (n, T); cache: {"k", "v": (B, S, Hkv, D),
    "kv_pos": (B, S)} or {"state", "conv"} of an SSD or RG-LRU layer.
    ``cross`` = (the layer's cross-attention params, {"k", "v": (B, F_pad,
    Hkv, D)} and the frame count "frames"), for an enc-dec decoder layer.
    With ``deferred`` (a list; ``kv_append="defer"``) an attention block
    reads the cache without writing it and appends its new (k, v) to the
    list instead.  Returns y (n, T, d).

    ``cache=None`` is training, :func:`_train_block` without its MoE
    auxiliary loss (``step`` is then ignored)."""
    if cache is None:
        return _train_block(cfg, kind, p, x, positions, force, cross)[0]
    h = L.apply_norm(cfg, x, p["norm1"])
    if kind == "ssd":
        return x + _recurrent_mixer(cfg, kind, p["ssd"], h, cache, step, force)
    if kind == "rglru":
        x = x + _recurrent_mixer(cfg, kind, p["rglru"], h, cache, step, force)
        return x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, x, p["norm2"]))
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    heads = L.attn_heads(cfg, p["attn"])
    q, k_new, v_new = L.attn_qkv(cfg, p["attn"], h, positions, heads)
    k_c, v_c, kv_pos = cache["k"], cache["v"], cache["kv_pos"]
    q = q.to(k_c.dtype)
    k_new, v_new = k_new.to(k_c.dtype), v_new.to(v_c.dtype)
    # what the rank's cache keeps (every KV head where "model" cuts the
    # sequence), and the whole heads its queries read
    if step.block is not None and step.block.axis == "model":
        k_own, v_own = heads.whole_kv(k_new), heads.whole_kv(v_new)
    else:
        k_own, v_own = heads.cached(k_new), heads.cached(v_new)
    k_new, v_new = heads.attended(k_new), heads.attended(v_new)
    window = cfg.sliding_window
    if deferred is not None:
        deferred.append((k_own, v_own))
    if step.start is None and step.block is not None:
        ctx = _block_decode(heads, q, k_new, v_new, k_own, v_own, cache, step, positions,
                            window, force, deferred)
    elif step.start is None:
        if deferred is None:
            _write_kv(cache, k_own, v_own, positions, step.rows)
        kc, vc, tables = _decode_view(heads, k_c, v_c, step, positions, bool(window))
        if deferred is not None:
            ctx = _deferred_decode(q, k_new, v_new, kc, vc, tables, step.context_lens, window,
                                   force)
        else:
            ctx = _paged(q, kc, vc, tables, step.context_lens, window, force)
    elif step.block is not None:
        ctx = _block_prefill(heads, q, k_new, v_new, k_own, v_own, cache, step, positions,
                             window, force, deferred)
    else:
        ctx = _prefill_attention(heads, q, k_new, v_new, k_own, v_own, cache, step.start,
                                 positions, window, force, deferred)
    x = x + L.attn_out(cfg, p["attn"], ctx.to(x.dtype))
    if cross is not None:
        x = x + _cross_attention(cfg, *cross, x, step, force)
    h2 = L.apply_norm(cfg, x, p["norm2"])
    if cfg.moe is not None:
        return x + _moe_fn(cfg)(cfg, p["moe"], h2, force=force)[0]
    return x + L.mlp(cfg, p["mlp"], h2)


def _prefill_attention(heads: L.AttnHeads, q, k_new, v_new, k_own, v_own, cache: Dict, s0: int,
                       positions, window, force, deferred=None):
    """A prefill chunk's attention at positions s0 .. s0 + T − 1 over one
    layer's cache {"k", "v", "kv_pos"}, which it writes (in place) unless
    ``deferred``: where no position of the row has wrapped, the chunk is
    written and K1 runs over the row up to its end; else the chunk attends
    over the cached keys and its own without reading what it writes
    (:func:`_prefill_segments`), then the ring keeps its last positions."""
    k_c, v_c, kv_pos = cache["k"], cache["v"], cache["kv_pos"]
    T, S = positions.shape[1], k_c.shape[1]
    if deferred is None and s0 + T <= S:
        # no position of the row has wrapped: write the chunk, then attend
        s1 = s0 + T
        k_c[:, s0:s1] = k_own
        v_c[:, s0:s1] = v_own
        kv_pos[:, s0:s1] = positions.to(kv_pos.dtype)
        if heads.kv_dh:
            # the cached prefix gathered to whole heads, then the chunk's own
            k_all, v_all = (torch.cat([heads.gathered(c[:, :s0]), new], 1) if s0 else new
                            for c, new in ((k_c, k_new), (v_c, v_new)))
        else:
            k_all, v_all = heads.attended(k_c[:, :s1]), heads.attended(v_c[:, :s1])
        return ops.flash_attention(q, k_all, v_all, causal=True, window=window, force=force)
    ctx = _prefill_segments(q, k_new, v_new, k_c, v_c, s0, window, force, view=heads.gathered)
    if deferred is None:
        _write_kv(cache, k_own, v_own, positions, None)
    return ctx


def _block_prefill(heads: L.AttnHeads, q, k_new, v_new, k_own, v_own, cache: Dict,
                   step: CacheStep, positions, window, force, deferred=None):
    """A prefill chunk on a rank that holds its block of the KV sequence
    (``step.block``): every rank attends for its own query heads as one
    process does and keeps the slots of its block.  The first chunk reads
    no cache: K1 over its own keys, causal with the window (one process's
    first chunk reads back exactly those keys); a later chunk gathers the
    layer's blocks over the block's axis into whole rows
    (``GATHERED["kv_prefix"]``), attends over them as one process does
    (:func:`_prefill_attention`, which writes the chunk into them, or
    reads them as they stand under ``deferred``) and keeps its block of
    them.  Over "model" (``kv_seq_shard``) the cache holds every KV head
    whole, ``k_own``/``v_own`` are the chunk's, and the rank's queries read
    their KV heads of them (``AttnHeads.over_whole``).  Under ``deferred``
    nothing is written here (``_apply_deferred_append`` writes the block's
    slots after the layers)."""
    block = step.block
    if step.start == 0:
        ctx = ops.flash_attention(q, k_new, v_new, causal=True, window=window, force=force)
        if deferred is None:
            _write_kv(cache, k_own, v_own, positions, None, block)
        return ctx
    whole = _gather_blocks(block, {name: cache[name] for name in ("k", "v", "kv_pos")})
    view = heads if block.axis == "data" else heads.over_whole()
    ctx = _prefill_attention(view, q, k_new, v_new, k_own, v_own, whole, step.start, positions,
                             window, force, deferred)
    if deferred is None:
        for name in ("k", "v", "kv_pos"):
            cache[name].copy_(whole[name][:, block.lo:block.hi])
    return ctx


def _block_decode(heads: L.AttnHeads, q, k_new, v_new, k_own, v_own, cache: Dict,
                  step: CacheStep, positions, window, force, deferred=None):
    """A decode on a rank that holds its block of the KV sequence
    (``step.block``): the token's k, v and position are written where the
    rank's block holds slot p % S, before the attention, as one process
    writes them (after every layer under ``deferred``); K2 runs over each
    of ``step.runs`` (:func:`block_runs`) with its lse, the runs are merged,
    and the ranks' blocks are merged over the block's axis
    (``layers.merge_blocks``).

    Over "data", the rank attends for its query heads: where the cache
    holds a block of head_dim, the decoded rows of its block are gathered
    over "model" to whole heads first (``layers.AttnHeads.gathered``).
    Over "model" (``kv_seq_shard``; the cache holds every KV head whole,
    and ``k_own``/``v_own`` are the token's every KV head), the rank's
    query heads are gathered to every head, K2 runs for each of them over
    the block, and the rank keeps its own query heads of the merge.

    Under ``deferred`` the runs are those of the cache before the token
    (``block_runs(..., deferred=True)``), and the token's own key, whose
    output is its value and whose lse its one scaled score, is counted on
    the rank whose block holds slot p % S, so that the merge counts it
    once.  Returns (n, 1, Hq, D) fp32: the rank's query heads."""
    block = step.block
    if deferred is None:
        _write_kv(cache, k_own, v_own, positions, step.rows, block)
    q, kc, vc, at = _block_keys(heads, q, cache["k"], cache["v"], step.rows, block)
    k_self, v_self = (k_own, v_own) if block.axis == "model" else (k_new, v_new)
    per = block.size // PAGE_SIZE
    pages = torch.arange(per, device=q.device)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:-1], -math.inf, dtype=torch.float32, device=q.device)
    segs = []
    for idx, first, lens, w in step.runs:
        tables = (at[idx][:, None] * per + (first[:, None] + pages).clamp(max=per - 1)).int()
        o, m = _paged(q[idx], kc, vc, tables, lens, w, force, return_lse=True)
        segs.append((out.index_copy(0, idx, o.float()), lse.index_copy(0, idx, m)))
    if deferred is not None:
        slot = positions[:, 0] % block.whole
        own = ((slot >= block.lo) & (slot < block.hi))[:, None, None]
        o, m = _self_segment(q, k_self, v_self)
        segs.append((o.float(), torch.where(own, m, -math.inf)))
    if segs:
        out, lse = L.attention_merge(segs, torch.float32, return_lse=True)
    ctx = _merged(block, out, lse)
    return heads.own_q(ctx) if block.axis == "model" else ctx


def _block_keys(heads: L.AttnHeads, q, k_c, v_c, rows, block: SeqBlock):
    """What K2 reads for a decode of ``rows`` over a rank's block of the
    slots: (queries, keys, values, the rows of the keys that hold
    ``rows``).  Over "model" the cache holds every KV head whole and the
    queries are gathered to every head; over "data" the rank's queries
    read their KV heads, the decoded rows gathered over "model" to whole
    heads where the cache holds a block of head_dim."""
    if block.axis == "model":
        return heads.whole_q(q), k_c, v_c, rows
    if heads.kv_dh:
        return (q, heads.gathered(k_c[rows]), heads.gathered(v_c[rows]),
                torch.arange(rows.shape[0], device=rows.device))
    return q, heads.attended(k_c), heads.attended(v_c), rows


def _train_block(cfg: ModelConfig, kind: str, p: Dict, x, positions, force: Optional[str],
                 cross: Optional[Tuple[Dict, Tuple]]):
    """A block without a cache, the reference's ``cache is None`` branch:
    it attends over the batch's own T positions (causal, the config's
    window) through ``ops.flash_attention`` and writes nothing; ``cross``
    is (the cross-attention params, the encoder's (k, v) (B, F, Hkv, D):
    on a "model" rank the KV heads its query heads read, whole), over which
    the decoder attends without a mask.  Returns (y, the MoE
    block's ``moe_aux_loss`` or None)."""
    h = L.apply_norm(cfg, x, p["norm1"])
    if kind == "ssd":
        return x + L.ssd_prefill(cfg, p["ssd"], h, force=force)[0], None
    if kind == "rglru":
        x = x + L.rglru(cfg, p["rglru"], h)[0]
        return x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, x, p["norm2"])), None
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    heads = L.attn_heads(cfg, p["attn"])
    q, k, v = L.attn_qkv(cfg, p["attn"], h, positions, heads)
    ctx = ops.flash_attention(q, heads.attended(k), heads.attended(v), causal=True,
                              window=cfg.sliding_window, force=force)
    x = x + L.attn_out(cfg, p["attn"], ctx)
    if cross is not None:
        cp, (ek, ev) = cross
        xh = L.attn_heads(cfg, cp["attn"])
        hx = L.apply_norm(cfg, x, cp["norm"])
        if xh.group is not None:
            hx = L._Copy.apply(hx, xh.group)
        qx = L.attn_project(cp["attn"], hx, "q", xh, bias=False)
        x = x + L.attn_out(cfg, cp["attn"], ops.flash_attention(qx, ek, ev, causal=False,
                                                                force=force))
    h2 = L.apply_norm(cfg, x, p["norm2"])
    if cfg.moe is None:
        return x + L.mlp(cfg, p["mlp"], h2), None
    y, moe_aux = _moe_fn(cfg)(cfg, p["moe"], h2, force=force)
    return x + y, moe_aux["moe_aux_loss"]


def _train_stack(cfg: ModelConfig, kinds, blocks, x, positions, *, remat: bool,
                 force: Optional[str], crosses=None):
    """Run the blocks ``blocks`` (stacked (L, ...) leaves or a per-layer
    list) of kinds ``kinds`` without a cache; with ``remat`` each block runs
    under ``torch.utils.checkpoint``, which keeps only its input and runs it
    again in the backward.  ``crosses`` gives each decoder layer its
    ``cross`` argument.  A leaf a training rank holds a "data" block of
    (``layers.DataBlock``) is gathered inside the block, so that the
    backward pass gathers it again and the whole leaf lives only while the
    block runs; the block runs under the ambient mesh and row group of the
    call, which the backward pass's recomputation, on the card in autograd's
    own thread, would not see.  Returns (x, aux summed over the layers)."""
    aux: Dict[str, Any] = {}
    mesh, rows = L.ambient_mesh(), L.row_group()
    for i, kind in enumerate(kinds):
        cross = None if crosses is None else crosses[i]

        def block(h, p_l, cross=cross, kind=kind):
            with L.use_mesh(mesh), L.split_rows(rows):
                c = None if cross is None else (L.gathered(cross[0]), cross[1])
                return _train_block(cfg, kind, L.gathered(p_l), h, positions, force, c)

        p_l = _layer(blocks, i)
        if remat:
            x, layer_aux = checkpoint(block, x, p_l, use_reentrant=False)
        else:
            x, layer_aux = block(x, p_l)
        if layer_aux is not None:
            aux["moe_aux_loss"] = aux.get("moe_aux_loss", 0.0) + layer_aux
    return x, aux


def _paged(q, k_c, v_c, tables, lens, window, force, return_lse=False):
    """K2 over a slot cache (B, S, Hkv, D) read as pages; q: (n, 1, Hq, D).
    Returns (n, 1, Hq, D), and with ``return_lse`` the lse (n, 1, Hq)."""
    page_shape = (-1, PAGE_SIZE) + tuple(k_c.shape[2:])
    res = ops.paged_attention(q[:, 0].contiguous(), k_c.view(page_shape),
                              v_c.view(page_shape), tables, lens, window=window,
                              return_lse=return_lse, force=force)
    if return_lse:
        return res[0][:, None], res[1][:, None]
    return res[:, None]


def _prefill_segments(q, k_new, v_new, k_c, v_c, s0: int, window, force, view=None):
    """Attention of a prefill chunk at positions s0 .. s0 + T − 1 over the
    cached keys before s0 and the chunk's own, without writing the cache
    (the deferred append's decomposition, and a ring's): K1 over the chunk's
    keys, causal with the window, and K1 over each contiguous range of
    cache rows that holds keys the chunk sees, with ``q_offset`` counted
    from the range's first position (the causal mask is vacuous there, the
    window is not); their exact merge.

    The cached keys a chunk sees are positions [s0 − window + 1, s0) (all
    of [0, s0) without a window), at most window − 1 of them.  A row of S
    positions keeps position p at p % S, so they lie in at most two ranges
    of rows, split where p crosses a multiple of S; they are all still
    there, since S ≥ window wherever a row wraps.  The chunk's own keys are
    never read from the cache, so a chunk longer than its ring (or than the
    reference's ``window_slack``) loses nothing.  ``view`` maps a range of
    cache rows to the keys the queries read (a tensor-parallel rank's:
    ``layers.AttnHeads.gathered``); the rows themselves by default."""
    S = k_c.shape[1]
    view = view or (lambda t: t)
    segs = [L.attention_partial(q, k_new, v_new, window=window, force=force)]
    a = 0 if window is None else max(0, s0 - window + 1)
    while a < s0:                       # no range when no cached key is visible
        b = min(s0, (a // S + 1) * S)
        i = a % S
        segs.insert(-1, L.attention_partial(q, view(k_c[:, i:i + b - a]),
                                            view(v_c[:, i:i + b - a]),
                                            q_offset=s0 - a, window=window, force=force))
        a = b
    if len(segs) == 1:
        return segs[0][0]
    return L.attention_merge(segs, q.dtype)


def _write_kv(layers: Dict, k_new, v_new, positions, rows, block: Optional[SeqBlock] = None
              ) -> None:
    """Write new K/V (.., n, T, Hkv, D) and their positions into a cache
    (in place) at rows ``rows`` (all rows where None) and position % S,
    where S is the rows' length: a ring's, or a linear row's, in which
    p % S = p.  Only the last S of T positions are written, those a ring
    keeps.  ``layers`` is one layer's cache {"k", "v": (B, S, Hkv, D),
    "kv_pos": (B, S)} or a stacked one (L, B, S, ...), with new K/V
    (L, n, T, Hkv, D).  Given the rank's ``block`` of rows of S =
    ``block.whole`` slots, only the positions whose slots it holds are
    written, at their place in it."""
    k, v, kv_pos = layers["k"], layers["v"], layers["kv_pos"]
    if k.is_meta:
        return      # a cache on the meta device (launch.rank_cost) holds no values
    S = k.shape[-3] if block is None else block.whole
    n = min(positions.shape[1], S)
    positions = positions[:, -n:].long()
    if rows is None:
        rows = torch.arange(positions.shape[0], device=positions.device)
    slots = positions % S
    rows = rows[:, None].expand_as(slots)
    k_new, v_new = k_new[..., -n:, :, :], v_new[..., -n:, :, :]
    if block is not None:
        keep = (slots >= block.lo) & (slots < block.hi)
        at = (slice(None),) * (k_new.dim() - 4) + (keep,)          # past a stacked L
        rows, slots, positions = rows[keep], slots[keep] - block.lo, positions[keep]
        k_new, v_new = k_new[at], v_new[at]
    idx = (rows, slots)
    if k.dim() == 5:                                               # (L, B, S, Hkv, D)
        idx = (slice(None),) + idx
    k[idx] = k_new
    v[idx] = v_new
    kv_pos[idx] = positions.to(kv_pos.dtype)


def _self_segment(q, k_new, v_new):
    """A decoded token's attention over its own key alone, as a segment of
    an online-softmax merge: (its value for every query head, in q's type;
    the one scaled score, fp32, the lse)."""
    G = q.shape[2] // k_new.shape[2]
    k_self = k_new.repeat_interleave(G, dim=2)                     # (n, 1, Hq, D)
    return (v_new.repeat_interleave(G, dim=2).to(q.dtype),
            (q.float() * k_self.float()).sum(-1) / math.sqrt(q.shape[-1]))


def _deferred_decode(q, k_new, v_new, k_c, v_c, tables, lens, window, force):
    """Attention of one decoded token at pos over [cache[:pos] ‖ itself]
    without writing the cache: K2 over the cache's pages ``tables``
    (``lens`` is pos in defer mode; the window less one, since the token
    itself is one of the ``window`` keys it sees) and the token's own key,
    merged."""
    seg_self = _self_segment(q, k_new, v_new)
    if window == 1:
        return seg_self[0]
    seg_cache = _paged(q, k_c, v_c, tables, lens, None if window is None else window - 1,
                       force, return_lse=True)
    return L.attention_merge([seg_cache, seg_self], q.dtype)


def _decode_view(heads: L.AttnHeads, k_c, v_c, step: CacheStep, positions, ring: bool):
    """What K2 reads for a decode at ``positions`` (n, 1) into the rows
    ``step.rows``: (keys, values, block tables).  The cache itself and the
    step's tables, or, where the rank's cache holds a block of head_dim,
    the decoded rows gathered over "model" to whole heads: a cache of n
    rows (renumbered 0 .. n − 1) of the positions they hold, a ring's
    whole row and a linear row's pages up to the furthest position (read on
    the host once a step), with tables over it; K2's context lengths are
    the step's in both."""
    if not heads.kv_dh:
        return heads.attended(k_c), heads.attended(v_c), step.block_tables
    rows = step.rows
    S = k_c.shape[1]
    if step.live is None:
        furthest = int(positions.max()) if step.at is None else max(step.at)
        step.live = S if ring else min(S, (furthest // PAGE_SIZE + 1) * PAGE_SIZE)
    kc = heads.gathered(k_c[rows, :step.live])
    vc = heads.gathered(v_c[rows, :step.live])
    n = rows.shape[0]
    local = torch.arange(n, device=rows.device)
    return kc, vc, _page_tables(local, positions[:, 0], step.live, n, ring, rows.device)[0]


def _apply_deferred_append(layers: Dict, new_kv: List, positions, step: CacheStep) -> None:
    """Write deferred new K/V into the cache in place, one ``index_put_`` a
    leaf (:func:`_write_kv`): ``layers`` is a stacked (L, B, S, ...) cache
    and ``new_kv`` the L layers' (k, v) in order, or one layer's cache and
    its one (k, v).  positions: (n, T); the rows are ``step.rows`` on a
    decode, else all; on a rank that holds ``step.block`` of the sequence,
    only the positions whose slots it holds."""
    if layers["k"].dim() == 5:                                     # (L, B, S, Hkv, D)
        k_new = torch.stack([kv[0] for kv in new_kv])
        v_new = torch.stack([kv[1] for kv in new_kv])
    else:
        (k_new, v_new), = new_kv
    _write_kv(layers, k_new, v_new, positions, step.rows, step.block)


def _cross_attention(cfg: ModelConfig, cp: Dict, kv: Dict, x, step: CacheStep,
                     force: Optional[str]):
    """The decoder's cross-attention over the encoder's K/V, as the
    reference's: a norm, the query projection (no bias, no RoPE), attention
    over every one of the F frames, the output projection.  A prefill (all
    rows of the cache) runs K1 with ``causal=False``; a decode (``step.rows``)
    runs K2 over those rows' cross cache, F keys each.  On a rank whose
    cross cache holds a block of head_dim, those keys are gathered to whole
    heads first, as the self-attention's are.

    Where the rank holds a block of the frames (``kv["block"]``, a
    :class:`SeqBlock` over "data" or, under ``kv_seq_shard``, "model"), a
    prefill attends over the frames the encoder just gave (``kv["fresh"]``,
    the rank's heads of every frame) or, without them, over the blocks
    gathered over the block's axis; a decode runs K2 over the block's
    frames, no window (:func:`_block_cross`)."""
    heads = L.attn_heads(cfg, cp["attn"])
    hx = L.apply_norm(cfg, x, cp["norm"])
    if heads.group is not None:
        hx = L._Copy.apply(hx, heads.group)
    k_c, block = kv["k"], kv.get("block")
    qx = L.attn_project(cp["attn"], hx, "q", heads, bias=False).to(k_c.dtype)
    F = kv["frames"]
    if step.rows is None:
        view, k_all, v_all = heads, k_c, kv["v"]
        if kv.get("fresh") is not None:
            k_all, v_all = kv["fresh"]
        elif block is not None:
            whole = _gather_blocks(block, {"k": k_c, "v": kv["v"]})
            k_all, v_all = whole["k"], whole["v"]
            view = heads if block.axis == "data" else heads.over_whole()
        ctx = ops.flash_attention(qx, view.gathered(k_all[:, :F].to(k_c.dtype)),
                                  view.gathered(v_all[:, :F].to(k_c.dtype)), causal=False,
                                  force=force)
    elif block is not None:
        ctx = _block_cross(heads, qx, kv, step, force)
    else:
        # every row's F frames: the whole padded row, pages counted from 0
        frames = CacheStep(rows=step.rows, block_tables=step.cross_tables, live=k_c.shape[1])
        kc, vc, tables = _decode_view(heads, k_c, kv["v"], frames, step.rows[:, None] * 0, False)
        ctx = _paged(qx, kc, vc, tables, step.cross_lens, None, force)
    return L.attn_out(cfg, cp["attn"], ctx.to(x.dtype))


def _block_cross(heads: L.AttnHeads, q, kv: Dict, step: CacheStep, force):
    """A decode's cross-attention on a rank that holds a block of the
    frames (``kv["block"]``): K2 over the block's ``span`` real frames (its
    pad, after them, unread), no window, merged over the block's axis;
    over "model" for every query head of a cache of every KV head, the rank
    keeping its own, as :func:`_block_decode` does.  Returns (n, 1, Hq, D)
    fp32."""
    block, rows = kv["block"], step.rows
    n = rows.shape[0]
    q, kc, vc, at = _block_keys(heads, q, kv["k"], kv["v"], rows, block)
    per = block.size // PAGE_SIZE
    tables = (at[:, None] * per + torch.arange(per, device=rows.device)).int()
    lens = torch.full((n,), block.span, dtype=torch.int32, device=rows.device)
    out, lse = _paged(q, kc, vc, tables, lens, None, force, return_lse=True)
    ctx = _merged(block, out.float(), lse)
    return heads.own_q(ctx) if block.axis == "model" else ctx


def _recurrent_mixer(cfg: ModelConfig, kind: str, p: Dict, h, cache: Dict,
                     step: CacheStep, force: Optional[str]):
    """The SSD or RG-LRU mixer over its layer's states, which it updates in
    place: every row for a prefill, only ``step.rows`` for a decode."""
    if step.rows is None:
        if kind == "ssd":
            y, state, conv = L.ssd_prefill(cfg, p, h, cache["state"], cache["conv"],
                                           force=force)
        else:
            y, state, conv = L.rglru(cfg, p, h, cache["state"], cache["conv"])
        cache["state"].copy_(state)
        cache["conv"].copy_(conv)
    else:
        rows = step.rows
        step_fn = L.ssd_decode_step if kind == "ssd" else L.rglru_step
        y, state, conv = step_fn(cfg, p, h, cache["state"][rows], cache["conv"][rows])
        cache["state"][rows] = state
        cache["conv"][rows] = conv.to(cache["conv"].dtype)
    return y


def _layer(tree, i: int):
    """The i-th layer's view of a tree of stacked (L, ...) tensors, or the
    i-th entry of a per-layer list."""
    if isinstance(tree, list):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _page_tables(rows, positions, S: int, batch: int, ring: bool, device):
    """K2's view of the listed cache rows of S positions each, the rows'
    pages being consecutive in the cache, for queries at ``positions``
    (n,): (block tables (n, S/16) int32 — (n, S/16 + 1) for a ``ring`` —
    and each row's first logical page, which the caller takes from the
    context lengths, as K2 counts positions from the table's first page).

    A linear row maps logical page j (positions 16j .. 16j + 15) to
    physical page b·S/16 + j.  A ring keeps position p at p % S, so table
    slot i of row b is logical page first + i at physical page
    b·S/16 + (first + i) mod S/16, with first = max(0, p // 16 − S/16): the
    last slot holds the query's own page, and the S/16 + 1 slots reach back
    past any window W ≤ S, whose first key p − W + 1 lies on page
    (p − W + 1) // 16 ≥ first.

    K2 masks by position, so over a ring it is exact: the keys a query at p
    sees are p − W + 1 .. p, each in the ring (written in order, slot
    p' % S holds the newest position congruent to p', which is p' itself
    for p' > p − S), and a slot whose page aliases a newer one lies before
    the window, where K2 masks it or skips its partition whole.  At S = W
    exactly, the window's first and last logical pages are one physical
    page when p + 1 is not a multiple of 16: its slots up to p % 16 hold the
    last page's positions, read under the last page's (≤ p), and its slots
    after p % 16 still hold the first page's, read under the first page's
    (≥ p − W + 1), so each slot is read once, under the position it holds."""
    per_row = S // PAGE_SIZE
    width = per_row + int(ring)
    first = (positions.long() // PAGE_SIZE - (width - 1)).clamp(min=0)
    j = (first[:, None] + torch.arange(width, device=device)[None, :]) % per_row
    rows = torch.as_tensor(rows, device=device).long()
    return (rows[:, None] * per_row + j).int().contiguous(), first


def _device_runs(positions, block: SeqBlock, cfg: ModelConfig, at=None):
    """:func:`block_runs` of a decode at ``positions`` (n, 1), read on the
    host once a step unless the caller gives them as ``at`` (host ints),
    with each launch's rows, first pages and context lengths on the
    device."""
    dev = positions.device
    host = positions[:, 0].tolist() if at is None else list(at)
    return [(torch.tensor(ix, device=dev), torch.tensor(first, device=dev),
             torch.tensor(lens, dtype=torch.int32, device=dev), w)
            for ix, first, lens, w in block_runs(host, block, cfg.sliding_window,
                                                 cfg.kv_append == "defer")]


def _prefill_start(cache, S: int, T: int, start: Optional[int] = None,
                   window: Optional[int] = None) -> int:
    """The one ``cache_len`` all rows share, read on the host unless the
    caller gives it as ``start``, checked against the attention cache's
    rows of S slots, which must hold T more positions unless they are a
    ring of at least the ``window`` (which keeps every key a query sees)."""
    if start is None:
        starts = set(cache["cache_len"].tolist())
        if len(starts) != 1:
            raise ValueError(f"prefill of T={T} needs one cache_len for every row, "
                             f"got {sorted(starts)}")
        start = starts.pop()
    if start + T > S and (window is None or S < window):
        raise ValueError(f"prefill to position {start + T} overflows the "
                         f"cache of {S} positions")
    return start


# ==========================================================================
# decoder-only LM
# ==========================================================================

class TransformerLM:
    """Decoder LM over any layer pattern: stacked (L, ...) blocks for a
    uniform one, per-layer lists for a mixed one (RecurrentGemma)."""

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg
        kinds = set(cfg.layer_pattern)
        self.uniform: Optional[str] = cfg.layer_pattern[0] if len(kinds) == 1 else None
        # the parameter subtrees whose leaves stack the layers on axis 0
        self.stacked = ("blocks",) if self.uniform else ()
        self.has_attn = bool(kinds & set(ATTN_KINDS))
        self.recurrent = bool(kinds & set(RECURRENT_KINDS))
        # the window is the config's, on every attention layer: all of
        # them keep rings (cache_span)
        self.windowed = self.has_attn and bool(cfg.sliding_window)

    # ------------------------------------------------------------- params --
    def init(self, generator: Optional[torch.Generator] = None,
             dtype=torch.float32, device=None) -> Dict[str, Any]:
        """Random parameters on ``device``, by default ``generator``'s
        (``cuda`` when no generator is given: a fresh one seeded with 0); the
        meta device (the dry-run) takes a CPU generator and draws nothing."""
        if generator is None:
            generator = torch.Generator(resolve_device(device)).manual_seed(0)
        device = generator.device if device is None else torch.device(device)
        cfg = self.cfg
        params: Dict[str, Any] = {
            "embed": L.embed_init((cfg.vocab_size, cfg.d_model), generator,
                                  dtype=dtype, device=device),
            "final_norm": L.norm_params(cfg, dtype, device),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = L.dense_init((cfg.d_model, cfg.vocab_size), generator,
                                             dtype=dtype, device=device)
        if self.uniform:
            params["blocks"] = block_params(cfg, self.uniform, generator, dtype, device,
                                            lead=(cfg.num_layers,))
        else:
            params["blocks"] = [block_params(cfg, kind, generator, dtype, device)
                                for kind in cfg.layer_pattern]
        return params

    # -------------------------------------------------------------- embed --
    def _embed_inputs(self, params, inputs, *, train: bool = False):
        """(B, T, d): the token embeddings, after the frontend embeddings
        (B, F, d) where the config has a frontend and the inputs carry them.
        A training batch also carries ``labels`` and may carry ``loss_mask``."""
        allowed = {"tokens", "frontend_embeds"} if self.cfg.frontend else {"tokens"}
        if train:
            allowed |= {"labels", "loss_mask"}
        extra = set(inputs) - allowed
        if extra:
            raise ValueError(f"unsupported inputs {sorted(extra)}: positions "
                             "always follow the cache length")
        x = L.embed(self.cfg, params["embed"], inputs["tokens"])
        if "frontend_embeds" in inputs:
            x = torch.cat([inputs["frontend_embeds"].to(x.dtype), x], dim=1)
        return x

    def _unembed(self, params, x):
        return L.unembed(self.cfg, params, x)

    def _attn_cache(self, cache) -> Dict:
        """The cache leaves of the attention layers: the stacked ones, or
        the first attention layer's of a mixed stack (all share one S)."""
        layers = cache["layers"]
        if isinstance(layers, dict):
            return layers
        return layers[self.cfg.layer_pattern.index(
            next(k for k in self.cfg.layer_pattern if k in ATTN_KINDS))]

    # --------------------------------------------------------------- body --
    def _run(self, params, x, positions, cache, step: CacheStep, force):
        cfg = self.cfg
        deferred = [] if cfg.kv_append == "defer" and positions is not None else None
        for i, kind in enumerate(cfg.layer_pattern):
            cache_l = _layer(cache["layers"], i)
            x = run_block(cfg, kind, _layer(params["blocks"], i), x, positions, cache_l,
                          step=step, force=force, deferred=deferred)
            if deferred and not self.uniform:
                # a mixed stack writes each layer's right away, as the
                # reference's unrolled stack does
                _apply_deferred_append(cache_l, [deferred.pop()], positions, step)
        if deferred:
            # a uniform stack: every layer's new K/V in one write a leaf
            _apply_deferred_append(cache["layers"], deferred, positions, step)
        x = L.apply_norm(cfg, x[:, -1:, :], params["final_norm"])
        return self._unembed(params, x)[:, 0, :]

    # ------------------------------------------------------------- train --
    def train_loss(self, params, batch, *, remat: bool = True, loss_chunk: int = 512,
                   force: Optional[str] = None):
        """Teacher-forced cross-entropy, as the reference's ``train_loss``:
        ``batch`` holds ``tokens`` and ``labels`` (B, T), optionally
        ``loss_mask`` (B, T) and, for a frontend config, ``frontend_embeds``
        (B, F, d), whose positions carry no loss.  Where ``batch`` is a
        training rank's block of a microbatch's rows (``layers.split_rows``),
        the token losses and counts are summed over the group, so the loss
        is the microbatch's on every rank; a leaf cut over "data" is gathered
        where it is used (``layers.gathered``).  The logits are computed
        ``loss_chunk`` positions at a time in fp32, so that (B, T, vocab) is
        never whole; a ragged last chunk adds exactly what the reference's
        zero padding (mask 0) adds.  An MoE config adds 0.01 times the summed
        ``moe_aux_loss``.  Returns (loss, metrics {"loss" (the CE alone),
        "tokens", and "moe_aux_loss" for MoE}); ``force="plain"`` as for
        :meth:`prefill`."""
        cfg = self.cfg
        x = self._embed_inputs({"embed": L.gathered(params["embed"])}, batch, train=True)
        B, T = x.shape[:2]
        positions = torch.arange(T, device=x.device).expand(B, T)
        x, aux = _train_stack(cfg, cfg.layer_pattern, params["blocks"], x, positions,
                              remat=remat, force=force)
        x = L.apply_norm(cfg, x, params["final_norm"])
        if "frontend_embeds" in batch:
            x = x[:, batch["frontend_embeds"].shape[1]:]      # no loss on frontend positions
        labels = batch["labels"].long()
        S = x.shape[1]
        mask = batch.get("loss_mask")
        mask = (torch.ones((B, S), dtype=torch.float32, device=x.device) if mask is None
                else mask.float())
        head = "embed" if cfg.tie_embeddings else "unembed"
        head = {head: L.gathered(params[head])}
        total = x.new_zeros((), dtype=torch.float32)
        for c0 in range(0, S, loss_chunk):
            logits = L.at_least_f32(self._unembed(head, x[:, c0:c0 + loss_chunk]))
            logp = torch.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, labels[:, c0:c0 + loss_chunk, None])[..., 0]
            total = total + torch.sum(-ll * mask[:, c0:c0 + loss_chunk])
        count = mask.sum()
        rows = L.row_group()
        if rows is not None:
            total, count = L._Reduce.apply(total, rows), L._all_reduce(count, rows)
        denom = torch.clamp(count, min=1.0)
        loss = total / denom
        metrics = {"loss": loss.detach(), "tokens": denom}
        if "moe_aux_loss" in aux:
            loss = loss + 0.01 * aux["moe_aux_loss"]
            metrics["moe_aux_loss"] = aux["moe_aux_loss"].detach()
        return loss, metrics

    # ----------------------------------------------------------- serving --
    def init_cache(self, batch: int, cache_size: int, dtype=torch.bfloat16,
                   device=None, window_slack: int = 0, params=None,
                   seq_shard: bool = False) -> Dict[str, Any]:
        """An empty cache of ``batch`` rows for ``cache_size`` positions, a
        multiple of PAGE_SIZE where there is attention (``cuda`` unless
        ``device`` says otherwise), as the reference's: a windowed attention
        layer keeps a ring of min(cache_size, window) + ``window_slack``
        positions (:func:`cache_span`), any other ``cache_size``; recurrent
        rows hold a state of fixed size and no positions.  Each layer's
        leaves take their heads, head_dim and width from ``params`` (a
        tensor-parallel rank's blocks, ``launch.mesh.shard_params``), the
        config's without them.  Under a mesh with batch axes, or with
        ``seq_shard`` (the reference's ``kv_seq_shard`` opt: the KV sequence
        over "model"), only this rank's blocks of it by the cache rules for
        ``batch`` rows (:func:`_placed_cache`)."""
        if self.has_attn and cache_size % PAGE_SIZE:
            raise ValueError(f"cache_size {cache_size} must be a multiple of "
                             f"the page size {PAGE_SIZE}")
        return _placed_cache(self.cfg, batch, resolve_device(device), params,
                             lambda dev, p: self._cache(batch, cache_size, dtype, dev,
                                                        window_slack, p), seq_shard)

    def _cache(self, batch, cache_size, dtype, device, window_slack, params):
        cfg = self.cfg
        blocks = None if params is None else params["blocks"]
        if self.uniform:
            layers = block_cache(cfg, self.uniform, batch, cache_size, dtype, device,
                                 lead=(cfg.num_layers,), window_slack=window_slack, p=blocks)
        else:
            layers = [block_cache(cfg, kind, batch, cache_size, dtype, device,
                                  window_slack=window_slack,
                                  p=None if blocks is None else blocks[i])
                      for i, kind in enumerate(cfg.layer_pattern)]
        return {"layers": layers,
                "cache_len": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def prefill(self, params, inputs, cache, *, force: Optional[str] = None,
                start: Optional[int] = None):
        """Extend every row of ``cache`` (in place) with T new positions at
        cache_len + arange(T), the frontend embeddings (if given) and then the
        tokens; returns (last-position logits (B, V), the same cache).
        ``force="plain"`` runs the plain attention, SSD scan or per-expert
        loop on the card.  ``start`` is the rows' shared ``cache_len`` where
        the caller knows it, so it is not read on the host (a cache on the
        meta device, as the dry-run's, holds no values)."""
        tokens = inputs["tokens"]
        x = self._embed_inputs(params, inputs)
        B, T = x.shape[:2]
        if T == 1 and "frontend_embeds" not in inputs:
            rows = torch.arange(B, device=tokens.device)
            return self.decode_slots(params, cache, tokens, rows, force=force), cache
        if not self.has_attn:
            # each row goes on from its own state; positions play no part
            logits = self._run(params, x, None, cache, CacheStep(), force)
            cache["cache_len"] += T
            return logits, cache
        block = cache.get("seq_block")
        S = self._attn_cache(cache)["k"].shape[-3] if block is None else block.whole
        start = _prefill_start(cache, S, T, start, window=self.cfg.sliding_window)
        positions = (start + torch.arange(T, device=tokens.device)).expand(B, T)
        logits = self._run(params, x, positions, cache, CacheStep(start=start, block=block),
                           force)
        cache["cache_len"] += T
        return logits, cache

    def decode_step(self, params, cache, tokens, *, force: Optional[str] = None):
        """tokens: (B, 1) -> (logits (B, V), the same cache, updated)."""
        return self.prefill(params, {"tokens": tokens}, cache, force=force)

    def decode_slots(self, params, cache, tokens, slots, *,
                     force: Optional[str] = None, at=None):
        """Decode one token for each cache row in ``slots`` and no other.

        tokens: (n, 1); slots: (n,) row indices; each token goes at its row's
        ``cache_len``, which then grows by one (in place).  Returns logits
        (n, V).  ``at`` gives the rows' ``cache_len`` where the caller
        knows them (host ints), which a rank that holds a block of the KV
        sequence or of head_dim otherwise reads on the host (a cache on the
        meta device holds no values)."""
        rows = torch.as_tensor(slots, device=tokens.device).long()
        positions = cache["cache_len"][rows].long()[:, None]
        step = CacheStep(rows=rows, block=cache.get("seq_block"), at=at)
        if step.block is not None:
            step.runs = _device_runs(positions, step.block, self.cfg, at)
        elif self.has_attn:
            kv = self._attn_cache(cache)["k"]
            step.block_tables, first = _page_tables(rows, positions[:, 0], kv.shape[-3],
                                                    kv.shape[-4], self.windowed, tokens.device)
            # the keys K2 reads, counted from the table's first page: the
            # token's own is in the cache only when it is written before the
            # attention (inline)
            step.context_lens = (positions[:, 0] - first * PAGE_SIZE
                                 + int(self.cfg.kv_append == "inline")).int()
        x = L.embed(self.cfg, params["embed"], tokens)
        logits = self._run(params, x, positions, cache, step, force)
        cache["cache_len"][rows] += 1
        return logits


# ==========================================================================
# encoder-decoder (whisper)
# ==========================================================================

class EncDecLM:
    """Whisper-style encoder-decoder, as the reference's ``EncDecLM``.  The
    audio conv frontend is a stub there too: ``prefill`` may take frame
    embeddings (B, F, d), which the encoder turns into every decoder layer's
    cross-attention K/V in the cache; without them the decoder attends over
    the cache's cross K/V as they stand (zeros in a fresh cache)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.encoder is None:
            raise ValueError(f"{cfg.arch_id} has no encoder")
        check_supported(cfg)
        self.cfg = cfg.replace(kv_append="inline")      # enc-dec keeps inline
        self.has_attn, self.recurrent = True, False
        self.stacked = ("encoder", "decoder", "cross")

    # ------------------------------------------------------------- params --
    def init(self, generator: Optional[torch.Generator] = None,
             dtype=torch.float32, device=None) -> Dict[str, Any]:
        """Random parameters on ``device``, by default ``generator``'s
        (``cuda`` when no generator is given: a fresh one seeded with 0), in
        the reference's tree: stacked encoder, decoder and cross-attention
        layers."""
        if generator is None:
            generator = torch.Generator(resolve_device(device)).manual_seed(0)
        device = generator.device if device is None else torch.device(device)
        cfg = self.cfg
        kw = dict(dtype=dtype, device=device)
        return {
            "embed": L.embed_init((cfg.vocab_size, cfg.d_model), generator, **kw),
            "pos_embed": L.embed_init((cfg.max_seq_len, cfg.d_model), generator, **kw),
            "encoder": block_params(cfg, "attn", generator, dtype, device,
                                    lead=(cfg.encoder.num_layers,)),
            "decoder": block_params(cfg, "attn", generator, dtype, device,
                                    lead=(cfg.num_layers,)),
            "cross": {"norm": L.norm_params(cfg, dtype, device, lead=(cfg.num_layers,)),
                      "attn": L.attn_params(cfg, generator, dtype, device,
                                            lead=(cfg.num_layers,))},
            "enc_final_norm": L.norm_params(cfg, dtype, device),
            "final_norm": L.norm_params(cfg, dtype, device),
        }

    # ------------------------------------------------------------ encoder --
    def encode(self, params, frame_embeds, *, force: Optional[str] = None):
        """(B, F, d) frame embeddings -> encoder states (B, F, d): pre-norm
        blocks of bidirectional self-attention (K1, ``causal=False``) and
        MLP, then the final norm."""
        cfg = self.cfg
        x = frame_embeds
        B, F = x.shape[:2]
        positions = torch.arange(F, device=x.device).expand(B, F)
        enc = params["encoder"]
        for i in range(cfg.encoder.num_layers):
            p = L.gathered(_layer(enc, i))
            hn = L.apply_norm(cfg, x, p["norm1"])
            heads = L.attn_heads(cfg, p["attn"])
            q, k, v = L.attn_qkv(cfg, p["attn"], hn, positions, heads)
            ctx = ops.flash_attention(q, heads.attended(k), heads.attended(v), causal=False,
                                      force=force)
            x = x + L.attn_out(cfg, p["attn"], ctx.to(x.dtype))
            x = x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, x, p["norm2"]))
        return L.apply_norm(cfg, x, params["enc_final_norm"])

    def _cross_kv(self, params, enc_out, train: bool = False):
        """Every decoder layer's cross-attention K and V of the encoder
        states: two (L, B, F, Hkv, D) tensors, a rank's block of them where
        it holds the layers' blocks (its KV heads, or its block of head_dim:
        no RoPE, so the rank's own projection is what its cache keeps).
        ``train``: lists of each layer's, whole heads (a head_dim block
        gathered over "model" with its gradient), the KV heads the rank's
        query heads read; each layer's leaves gathered over "data" where a
        training rank holds a block of them (``layers.gathered``)."""
        ks, vs = [], []
        for i in range(self.cfg.num_layers):
            cp = L.gathered(_layer(params["cross"], i)["attn"])
            heads = L.attn_heads(self.cfg, cp)
            x = enc_out if heads.group is None else L._Copy.apply(enc_out, heads.group)
            kv = [L.attn_project(cp, x, n, heads, bias=False, whole=train) for n in "kv"]
            if train:
                kv = [heads.attended(t) for t in kv]
            ks.append(kv[0])
            vs.append(kv[1])
        return (ks, vs) if train else (torch.stack(ks), torch.stack(vs))

    # ------------------------------------------------------------- train --
    def train_loss(self, params, batch, *, remat: bool = True, loss_chunk: int = 512,
                   force: Optional[str] = None):
        """The reference's enc-dec ``train_loss``: the encoder over
        ``batch["frontend_embeds"]`` (B, F, d), every decoder layer's cross
        K/V from it, then the decoder over ``tokens`` (B, S) at positions
        0 .. S − 1 (token and learned position embeddings), each layer's
        cross-attention through K1 without the causal mask; the CE of
        ``labels`` over the whole (B, S, vocab) in fp32 (no chunking, as the
        reference; ``loss_chunk`` is unused), with ``loss_mask`` if given.
        ``remat`` checkpoints the decoder's blocks, as the reference does.
        On a training rank (as :meth:`TransformerLM.train_loss`): the
        embedding and the logits are vocabulary-parallel where the rank
        holds a block of the vocabulary (``layers.embed``,
        ``layers.unembed``), each leaf cut over "data" is gathered where it
        is used, the frames' rows are split with the tokens', and the token
        losses and counts are summed over the rows' group.  Returns (loss,
        {"loss", "tokens"})."""
        cfg = self.cfg
        extra = set(batch) - {"tokens", "labels", "loss_mask", "frontend_embeds"}
        if extra:
            raise ValueError(f"unsupported inputs {sorted(extra)}: positions "
                             "always run from 0")
        enc_out = self.encode(params, batch["frontend_embeds"], force=force)
        ck, cv = self._cross_kv(params, enc_out, train=True)
        tokens, labels = batch["tokens"], batch["labels"].long()
        B, S = tokens.shape
        embed = L.gathered(params["embed"])
        x = L.embed(cfg, embed, tokens) + L.gathered(params["pos_embed"])[:S][None]
        positions = torch.arange(S, device=x.device).expand(B, S)
        crosses = [(_layer(params["cross"], i), (ck[i], cv[i])) for i in range(cfg.num_layers)]
        x, _ = _train_stack(cfg, ["attn"] * cfg.num_layers, params["decoder"], x, positions,
                            remat=remat, force=force, crosses=crosses)
        x = L.apply_norm(cfg, x, params["final_norm"])
        logp = torch.log_softmax(L.at_least_f32(L.unembed(cfg, {"embed": embed}, x)), dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        mask = (torch.ones((B, S), dtype=torch.float32, device=x.device) if mask is None
                else mask.float())
        total, count = torch.sum(-ll * mask), mask.sum()
        rows = L.row_group()
        if rows is not None:
            total, count = L._Reduce.apply(total, rows), L._all_reduce(count, rows)
        loss = total / torch.clamp(count, min=1.0)
        return loss, {"loss": loss.detach(), "tokens": count}

    # ----------------------------------------------------------- serving --
    def init_cache(self, batch: int, cache_size: int, dtype=torch.bfloat16,
                   device=None, *, enc_frames: Optional[int] = None,
                   params=None, seq_shard: bool = False) -> Dict[str, Any]:
        """The decoder's self-attention cache, as :class:`TransformerLM`'s,
        and the cross-attention K/V of ``enc_frames`` frames (the encoder's
        ``max_source_positions`` by default) a row, padded to a whole number
        of K2's pages: ``cross_k``/``cross_v`` (L, B, F_pad, Hkv, D), zeros.
        The K/V take their heads and head_dim from ``params`` (a
        tensor-parallel rank's blocks of the decoder's and the cross
        attention's), the config's without them.  Under a mesh with batch
        axes, or with ``seq_shard``, this rank's blocks of it
        (:func:`_placed_cache`): its rows, or its block of the KV sequence and
        of the frames (F / n of them, padded after them to whole pages)."""
        if cache_size % PAGE_SIZE:
            raise ValueError(f"cache_size {cache_size} must be a multiple of "
                             f"the page size {PAGE_SIZE}")
        return _placed_cache(self.cfg, batch, resolve_device(device), params,
                             lambda dev, p: self._cache(batch, cache_size, dtype, dev, enc_frames,
                                                        p), seq_shard)

    def _cache(self, batch, cache_size, dtype, device, enc_frames, params):
        cfg = self.cfg
        F = enc_frames or cfg.encoder.max_source_positions
        F_pad = whole_pages(F)
        heads = ((cfg.num_kv_heads, cfg.head_dim) if params is None
                 else tuple(params["cross"]["attn"]["wk"].shape[-2:]))
        xk = torch.zeros((cfg.num_layers, batch, F_pad) + heads, dtype=dtype, device=device)
        return {"layers": block_cache(cfg, "attn", batch, cache_size, dtype, device,
                                      lead=(cfg.num_layers,),
                                      p=None if params is None else params["decoder"]),
                "cross_k": xk, "cross_v": torch.zeros(xk.shape, dtype=dtype, device=device),
                "cross_frames": F,
                "cache_len": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def _decoder(self, params, tokens, positions, cache, step: CacheStep, force, fresh=None):
        cfg = self.cfg
        pos = torch.clamp(positions, 0, cfg.max_seq_len - 1)
        x = L.embed(cfg, params["embed"], tokens) + params["pos_embed"][pos]
        for i in range(cfg.num_layers):
            kv = {"k": cache["cross_k"][i], "v": cache["cross_v"][i],
                  "frames": cache["cross_frames"], "block": cache.get("cross_block"),
                  "fresh": None if fresh is None else (fresh[0][i], fresh[1][i])}
            x = run_block(cfg, "attn", _layer(params["decoder"], i), x, positions,
                          _layer(cache["layers"], i), step=step, force=force,
                          cross=(_layer(params["cross"], i), kv))
        x = L.apply_norm(cfg, x[:, -1:, :], params["final_norm"])
        return L.unembed(cfg, params, x)[:, 0, :]       # whisper ties its embeddings

    def prefill(self, params, inputs, cache, *, force: Optional[str] = None,
                start: Optional[int] = None):
        """The encoder over ``inputs["frontend_embeds"]`` (B, F, d) where
        given, its cross K/V written into every row of the cache, then the
        decoder over the T tokens at cache_len + arange(T) (in place);
        returns (last-position logits (B, V), the same cache).  ``start``
        as for :meth:`TransformerLM.prefill`."""
        extra = set(inputs) - {"tokens", "frontend_embeds"}
        if extra:
            raise ValueError(f"unsupported inputs {sorted(extra)}: positions "
                             "always follow the cache length")
        tokens = inputs["tokens"]
        B, T = tokens.shape
        fresh = None
        if "frontend_embeds" in inputs:
            fe = inputs["frontend_embeds"]
            if fe.shape[1] != cache["cross_frames"]:
                raise ValueError(f"{fe.shape[1]} frames for a cache of "
                                 f"{cache['cross_frames']}")
            ck, cv = self._cross_kv(params, self.encode(params, fe.to(params["embed"].dtype),
                                                        force=force))
            F = fe.shape[1]
            xb = cache.get("cross_block")
            if xb is None:
                cache["cross_k"][:, :, :F] = ck.to(cache["cross_k"].dtype)
                cache["cross_v"][:, :, :F] = cv.to(cache["cross_v"].dtype)
            else:
                # every rank encoded every frame: it keeps its block of them
                # (every KV head over "model"), the block's pad after them,
                # and attends over them all now
                heads = L.attn_heads(self.cfg, _layer(params["cross"], 0)["attn"])
                for name, t in (("cross_k", ck), ("cross_v", cv)):
                    if xb.axis == "model":
                        t = heads.whole_kv(t)
                    cache[name][:, :, :xb.span] = t[:, :, xb.lo:xb.hi].to(cache[name].dtype)
                fresh = (ck, cv)
        if T == 1:
            rows = torch.arange(B, device=tokens.device)
            return self.decode_slots(params, cache, tokens, rows, force=force), cache
        block = cache.get("seq_block")
        S = cache["layers"]["k"].shape[-3] if block is None else block.whole
        start = _prefill_start(cache, S, T, start)
        positions = (start + torch.arange(T, device=tokens.device)).expand(B, T)
        logits = self._decoder(params, tokens, positions, cache,
                               CacheStep(start=start, block=block), force, fresh)
        cache["cache_len"] += T
        return logits, cache

    def decode_step(self, params, cache, tokens, *, force: Optional[str] = None):
        """tokens: (B, 1) -> (logits (B, V), the same cache, updated)."""
        return self.prefill(params, {"tokens": tokens}, cache, force=force)

    def decode_slots(self, params, cache, tokens, slots, *,
                     force: Optional[str] = None, at=None):
        """As :meth:`TransformerLM.decode_slots`; the cross-attention reads
        the listed rows' cross K/V through K2, F keys each."""
        rows = torch.as_tensor(slots, device=tokens.device).long()
        positions = cache["cache_len"][rows].long()[:, None]
        kv, xk = cache["layers"]["k"], cache["cross_k"]
        n = rows.shape[0]
        step = CacheStep(rows=rows, block=cache.get("seq_block"), at=at)
        if step.block is not None:
            step.runs = _device_runs(positions, step.block, self.cfg, at)
        else:
            step.block_tables = _page_tables(rows, positions[:, 0], kv.shape[-3], kv.shape[-4],
                                             False, tokens.device)[0]
            step.context_lens = (positions[:, 0] + 1).int()
        if "cross_block" not in cache:
            step.cross_tables = _page_tables(rows, positions[:, 0] * 0, xk.shape[-3],
                                             xk.shape[-4], False, tokens.device)[0]
            step.cross_lens = torch.full((n,), cache["cross_frames"], dtype=torch.int32,
                                         device=tokens.device)
        logits = self._decoder(params, tokens, positions, cache, step, force)
        cache["cache_len"][rows] += 1
        return logits


def _placed_cache(cfg: ModelConfig, batch: int, device, params, build,
                  seq_shard: bool = False) -> Dict[str, Any]:
    """``build(device, params)``, a model's cache; under an ambient mesh
    with batch axes, or with ``seq_shard`` (the reference's
    ``kv_seq_shard``) on more than one "model" rank, only this rank's blocks
    of it by the cache rules for ``batch`` rows (``launch.mesh.shard_cache``,
    the one place the rules live), worked out on the meta device and then
    allocated on ``device``: its rows where the batch axes divide
    ``batch``, else its block of the attention layers' KV slots (and of an
    encoder-decoder's frames) over "data", the recurrent states whole; with
    ``seq_shard``, where the batch axes divide ``batch``, its block of the
    KV slots (and frames) over "model" of every KV head whole.  A block is
    a :class:`SeqBlock` in the cache's "seq_block" (the frames' in
    "cross_block": the reference's F / n frames a rank, in whole pages of
    K2, the pad after them).  Raises unless a block of the KV sequence is a
    whole number of K2's pages, naming the leaf."""
    mesh = L.ambient_mesh()
    if L.batch_coordinate(mesh)[1] == 1 and not (seq_shard and L.model_coordinate(mesh)[1] > 1):
        return build(device, params)
    from repro_torch.launch.mesh import mesh_axes, seq_blocks, shard_cache
    whole = build("meta", None)
    # every KV head whole where "model" may cut the sequence: cut the whole tree
    held = whole if seq_shard else build("meta", params)
    cache = _allocate(shard_cache(held, mesh, batch=batch, whole=whole, seq_shard=seq_shard),
                      device)
    axes = mesh_axes(mesh)
    cache.update(seq_blocks(whole, axes, {a: mesh[a].get_local_rank() for a in axes.names},
                            batch=batch, seq_shard=seq_shard))
    return cache


def _allocate(tree, device):
    """A cache shaped as ``tree`` (the meta device will do) on ``device``:
    ``kv_pos`` filled with −1, every other tensor with 0; other leaves
    as they are."""
    if isinstance(tree, dict):
        return {k: (torch.full(v.shape, -1, dtype=v.dtype, device=device) if k == "kv_pos"
                    else _allocate(v, device)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_allocate(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    return tree


def build_model(cfg: ModelConfig):
    if cfg.is_enc_dec:
        return EncDecLM(cfg)
    return TransformerLM(cfg)
