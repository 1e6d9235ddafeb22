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
sees the keys at p − window + 1 .. p.  The cache stays linear,
``cache_size`` positions a row, where the reference keeps a ring of about
one window (``positions % S``): the same function, since the reference also
masks by position, at the memory of the whole context.

An MoE block (``cfg.moe``) replaces the MLP with :func:`layers.moe`; its
auxiliary outputs are dropped, as serving does in the reference.  A
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
two segments and merges them exactly (:func:`layers.attention_merge2`):

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
reference's unrolled stack does.  The encoder-decoder keeps the inline
append, as the reference's ``EncDecLM`` does.

Training (``train_loss``, as the reference's) runs every block without a
cache (:func:`_train_block`, which :func:`run_block` also runs given
``cache=None``): attention over the T positions of the batch through
``ops.flash_attention``, causal from 0 with the config's window (no mask
for the encoder and the cross-attention), which on the card is K1 forward
and K1's gradient kernel backward; SSD, RG-LRU and MoE blocks as in a
prefill from a zero state.  ``remat`` wraps each block in
``torch.utils.checkpoint``.  On the CPU every architecture trains; on the
card an SSD block refuses to (K3 has no gradient kernel yet), naming its
ROADMAP item, and so does ``moe_impl="a2a"`` anywhere.
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

_ROADMAP = {
    "a2a": "ROADMAP Queue A item 14 (expert-parallel MoE)",
    "train": "ROADMAP Queue A item 13b (K3's backward kernel: training SSD layers on the card)",
}


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} does not run in the PyTorch port yet: "
                               f"{_ROADMAP[what]}")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any part of ``cfg`` the port does not run yet."""
    for kind in cfg.layer_pattern:
        if kind not in ATTN_KINDS + RECURRENT_KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
    if cfg.kv_append not in ("inline", "defer"):
        raise ValueError(f"unknown kv_append {cfg.kv_append!r}")
    if cfg.moe is not None and cfg.moe_impl != "ragged":
        raise _unported("a2a")


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


def block_cache(cfg: ModelConfig, kind: str, batch: int, cache_size: int, dtype,
                device=None, lead=()) -> Dict:
    """Cache leaves of one block; ``lead=(L,)`` stacks L blocks on axis 0.
    SSD and RG-LRU states are fp32 whatever ``dtype`` is, and take no
    ``cache_size``."""
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "ssd":
        ssm = cfg.ssm
        lead = tuple(lead) + (batch,)
        return {"state": torch.zeros(lead + (ssm.num_heads(cfg.d_model), ssm.state_dim,
                                             ssm.head_dim), **f32),
                "conv": torch.zeros(lead + (ssm.conv_width - 1,
                                            ssm.d_inner(cfg.d_model) + 2 * ssm.state_dim),
                                    **f32)}
    if kind == "rglru":
        rg = cfg.rglru
        lead = tuple(lead) + (batch,)
        return {"state": torch.zeros(lead + (rg.lru_width,), **f32),
                "conv": torch.zeros(lead + (rg.conv_width - 1, rg.lru_width), **f32)}
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    shape = tuple(lead) + (batch, cache_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kv_pos": torch.full(shape[:-2], -1, dtype=torch.int32, device=device)}


@dataclass
class CacheStep:
    """Where one forward's tokens go in the cache, worked out once for all
    layers.  Attention prefill (T > 1) sets ``start``; decode (T = 1) sets
    ``rows`` (and, for attention, the rest); SSD prefill sets nothing."""

    start: Optional[int] = None                  # first position of every row
    rows: Optional[torch.Tensor] = None          # (n,) cache rows decoded
    block_tables: Optional[torch.Tensor] = None  # (n, S / PAGE_SIZE) int32
    context_lens: Optional[torch.Tensor] = None  # (n,) int32
    cross_tables: Optional[torch.Tensor] = None  # (n, F_pad / PAGE_SIZE) int32, enc-dec
    cross_lens: Optional[torch.Tensor] = None    # (n,) int32: F, enc-dec


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
    q, k_new, v_new = L.attn_qkv(cfg, p["attn"], h, positions)
    k_c, v_c, kv_pos = cache["k"], cache["v"], cache["kv_pos"]
    q = q.to(k_c.dtype)
    T = positions.shape[1]
    window = cfg.sliding_window
    if deferred is not None:
        k_new, v_new = k_new.to(k_c.dtype), v_new.to(v_c.dtype)
        deferred.append((k_new, v_new))
        if step.start is not None:
            ctx = _deferred_prefill(q, k_new, v_new, k_c, v_c, step.start, window, force)
        else:
            ctx = _deferred_decode(q, k_new, v_new, k_c, v_c, step, window, force)
    elif step.start is not None:
        s0, s1 = step.start, step.start + T
        k_c[:, s0:s1] = k_new.to(k_c.dtype)
        v_c[:, s0:s1] = v_new.to(v_c.dtype)
        kv_pos[:, s0:s1] = positions.to(kv_pos.dtype)
        ctx = ops.flash_attention(q, k_c[:, :s1], v_c[:, :s1], causal=True,
                                  window=window, force=force)
    else:
        rows, pos = step.rows, positions[:, 0].long()
        k_c[rows, pos] = k_new[:, 0].to(k_c.dtype)
        v_c[rows, pos] = v_new[:, 0].to(v_c.dtype)
        kv_pos[rows, pos] = pos.to(kv_pos.dtype)
        ctx = _paged(q, k_c, v_c, step.block_tables, step.context_lens, window, force)
    x = x + L.attn_out(p["attn"], ctx.to(x.dtype))
    if cross is not None:
        x = x + _cross_attention(cfg, *cross, x, step, force)
    h2 = L.apply_norm(cfg, x, p["norm2"])
    if cfg.moe is not None:
        return x + L.moe(cfg, p["moe"], h2, force=force)[0]
    return x + L.mlp(cfg, p["mlp"], h2)


def _train_block(cfg: ModelConfig, kind: str, p: Dict, x, positions, force: Optional[str],
                 cross: Optional[Tuple[Dict, Tuple]]):
    """A block without a cache, the reference's ``cache is None`` branch:
    it attends over the batch's own T positions (causal, the config's
    window) through ``ops.flash_attention`` and writes nothing; ``cross``
    is (the cross-attention params, the encoder's (k, v) (B, F, Hkv, D)),
    over which the decoder attends without a mask.  Returns (y, the MoE
    block's ``moe_aux_loss`` or None).  An SSD block refuses to train on the
    card: K3 has no gradient kernel yet."""
    h = L.apply_norm(cfg, x, p["norm1"])
    if kind == "ssd":
        if ops._use_kernel(h, force):
            raise _unported("train")
        return x + L.ssd_prefill(cfg, p["ssd"], h, force=force)[0], None
    if kind == "rglru":
        x = x + L.rglru(cfg, p["rglru"], h)[0]
        return x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, x, p["norm2"])), None
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    q, k, v = L.attn_qkv(cfg, p["attn"], h, positions)
    ctx = ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window, force=force)
    x = x + L.attn_out(p["attn"], ctx)
    if cross is not None:
        cp, (ek, ev) = cross
        qx = L._proj_heads(L.apply_norm(cfg, x, cp["norm"]), cp["attn"]["wq"])
        x = x + L.attn_out(cp["attn"], ops.flash_attention(qx, ek, ev, causal=False,
                                                           force=force))
    h2 = L.apply_norm(cfg, x, p["norm2"])
    if cfg.moe is None:
        return x + L.mlp(cfg, p["mlp"], h2), None
    y, moe_aux = L.moe(cfg, p["moe"], h2, force=force)
    return x + y, moe_aux["moe_aux_loss"]


def _train_stack(cfg: ModelConfig, kinds, blocks, x, positions, *, remat: bool,
                 force: Optional[str], crosses=None):
    """Run the blocks ``blocks`` (stacked (L, ...) leaves or a per-layer
    list) of kinds ``kinds`` without a cache; with ``remat`` each block runs
    under ``torch.utils.checkpoint``, which keeps only its input and runs it
    again in the backward.  ``crosses`` gives each decoder layer its
    ``cross`` argument.  Returns (x, aux summed over the layers)."""
    aux: Dict[str, Any] = {}
    for i, kind in enumerate(kinds):
        cross = None if crosses is None else crosses[i]

        def block(h, p_l, cross=cross, kind=kind):
            return _train_block(cfg, kind, p_l, h, positions, force, cross)

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


def _deferred_prefill(q, k_new, v_new, k_c, v_c, s0: int, window, force):
    """Attention of a prefill chunk at s0 over [cache[:s0] ‖ the chunk]
    without writing the cache: two K1 segments and their merge."""
    seg_new = L.attention_partial(q, k_new, v_new, window=window, force=force)
    if s0 == 0 or window == 1:          # no cached key is visible
        return seg_new[0]
    seg_cache = L.attention_partial(q, k_c[:, :s0], v_c[:, :s0], q_offset=s0,
                                    window=window, force=force)
    return L.attention_merge2(seg_cache, seg_new, q.dtype)


def _deferred_decode(q, k_new, v_new, k_c, v_c, step: CacheStep, window, force):
    """Attention of one decoded token at pos over [cache[:pos] ‖ itself]
    without writing the cache: K2 over the cache (``step.context_lens`` is
    pos in defer mode; the window less one, since the token itself is one of
    the ``window`` keys it sees) and the token's own key, merged."""
    G = q.shape[2] // k_new.shape[2]
    k_self = k_new.repeat_interleave(G, dim=2)                     # (n, 1, Hq, D)
    seg_self = (v_new.repeat_interleave(G, dim=2).to(q.dtype),
                (q.float() * k_self.float()).sum(-1) / math.sqrt(q.shape[-1]))
    if window == 1:
        return seg_self[0]
    seg_cache = _paged(q, k_c, v_c, step.block_tables, step.context_lens,
                       None if window is None else window - 1, force, return_lse=True)
    return L.attention_merge2(seg_cache, seg_self, q.dtype)


def _apply_deferred_append(layers: Dict, new_kv: List, positions, step: CacheStep) -> None:
    """Write deferred new K/V into the cache in place, one ``index_put_`` a
    leaf: ``layers`` is a stacked (L, B, S, ...) cache and ``new_kv`` the L
    layers' (k, v) in order, or one layer's cache and its one (k, v).
    positions: (n, T); the rows are ``step.rows`` on a decode, else all."""
    k, v, kv_pos = layers["k"], layers["v"], layers["kv_pos"]
    rows = (step.rows if step.rows is not None
            else torch.arange(positions.shape[0], device=positions.device))[:, None]
    idx = (rows, positions.long())
    if k.dim() == 5:                                               # (L, B, S, Hkv, D)
        idx = (slice(None),) + idx
        k_new = torch.stack([kv[0] for kv in new_kv])
        v_new = torch.stack([kv[1] for kv in new_kv])
    else:
        (k_new, v_new), = new_kv
    k[idx] = k_new
    v[idx] = v_new
    kv_pos[idx] = positions.to(kv_pos.dtype)


def _cross_attention(cfg: ModelConfig, cp: Dict, kv: Dict, x, step: CacheStep,
                     force: Optional[str]):
    """The decoder's cross-attention over the encoder's K/V, as the
    reference's: a norm, the query projection (no bias, no RoPE), attention
    over every one of the F frames, the output projection.  A prefill (all
    rows of the cache) runs K1 with ``causal=False``; a decode (``step.rows``)
    runs K2 over those rows' cross cache, F keys each."""
    hx = L.apply_norm(cfg, x, cp["norm"])
    k_c = kv["k"]
    qx = L._proj_heads(hx, cp["attn"]["wq"]).to(k_c.dtype)
    if step.rows is None:
        F = kv["frames"]
        ctx = ops.flash_attention(qx, k_c[:, :F], kv["v"][:, :F], causal=False, force=force)
    else:
        ctx = _paged(qx, k_c, kv["v"], step.cross_tables, step.cross_lens, None, force)
    return L.attn_out(cp["attn"], ctx.to(x.dtype))


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


def _page_tables(rows, S: int, batch: int, device):
    """Block tables (n, S / PAGE_SIZE) of the listed cache rows of S
    positions each, the rows' pages being consecutive in the cache."""
    tables = torch.arange(batch * S // PAGE_SIZE, dtype=torch.int32,
                          device=device).view(batch, S // PAGE_SIZE)
    return tables[rows].contiguous()


def _prefill_start(cache, k, T: int) -> int:
    """The one ``cache_len`` all rows share, checked against the attention
    cache ``k`` (.., B, S, Hkv, D), which must hold T more positions."""
    starts = set(cache["cache_len"].tolist())
    if len(starts) != 1:
        raise ValueError(f"prefill of T={T} needs one cache_len for every row, "
                         f"got {sorted(starts)}")
    start = starts.pop()
    S = k.shape[-3]
    if start + T > S:
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

    # ------------------------------------------------------------- params --
    def init(self, generator: Optional[torch.Generator] = None,
             dtype=torch.float32, device=None) -> Dict[str, Any]:
        """Random parameters on ``generator``'s device (``cuda`` when no
        generator is given: a fresh one seeded with 0)."""
        if generator is None:
            generator = torch.Generator(resolve_device(device)).manual_seed(0)
        device = generator.device
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
        x = params["embed"][inputs["tokens"]]
        if "frontend_embeds" in inputs:
            x = torch.cat([inputs["frontend_embeds"].to(x.dtype), x], dim=1)
        return x

    def _unembed(self, params, x):
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return x @ w

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
        (B, F, d), whose positions carry no loss.  The logits are computed
        ``loss_chunk`` positions at a time in fp32, so that (B, T, vocab) is
        never whole; a ragged last chunk adds exactly what the reference's
        zero padding (mask 0) adds.  An MoE config adds 0.01 times the summed
        ``moe_aux_loss``.  Returns (loss, metrics {"loss" (the CE alone),
        "tokens", and "moe_aux_loss" for MoE}); ``force="plain"`` as for
        :meth:`prefill`."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch, train=True)
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
        total = x.new_zeros((), dtype=torch.float32)
        for c0 in range(0, S, loss_chunk):
            logits = self._unembed(params, x[:, c0:c0 + loss_chunk]).float()
            logp = torch.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, labels[:, c0:c0 + loss_chunk, None])[..., 0]
            total = total + torch.sum(-ll * mask[:, c0:c0 + loss_chunk])
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = total / denom
        metrics = {"loss": loss.detach(), "tokens": denom}
        if "moe_aux_loss" in aux:
            loss = loss + 0.01 * aux["moe_aux_loss"]
            metrics["moe_aux_loss"] = aux["moe_aux_loss"].detach()
        return loss, metrics

    # ----------------------------------------------------------- serving --
    def init_cache(self, batch: int, cache_size: int, dtype=torch.bfloat16,
                   device=None) -> Dict[str, Any]:
        """An empty cache of ``batch`` rows of ``cache_size`` positions, a
        multiple of PAGE_SIZE where there is attention (``cuda`` unless
        ``device`` says otherwise).  Recurrent rows hold a state of fixed
        size and no positions."""
        if self.has_attn and cache_size % PAGE_SIZE:
            raise ValueError(f"cache_size {cache_size} must be a multiple of "
                             f"the page size {PAGE_SIZE}")
        device = resolve_device(device)
        cfg = self.cfg
        if self.uniform:
            layers = block_cache(cfg, self.uniform, batch, cache_size, dtype, device,
                                 lead=(cfg.num_layers,))
        else:
            layers = [block_cache(cfg, kind, batch, cache_size, dtype, device)
                      for kind in cfg.layer_pattern]
        return {"layers": layers,
                "cache_len": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def prefill(self, params, inputs, cache, *, force: Optional[str] = None):
        """Extend every row of ``cache`` (in place) with T new positions at
        cache_len + arange(T), the frontend embeddings (if given) and then the
        tokens; returns (last-position logits (B, V), the same cache).
        ``force="plain"`` runs the plain attention, SSD scan or per-expert
        loop on the card."""
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
        start = _prefill_start(cache, self._attn_cache(cache)["k"], T)
        positions = (start + torch.arange(T, device=tokens.device)).expand(B, T)
        logits = self._run(params, x, positions, cache, CacheStep(start=start), force)
        cache["cache_len"] += T
        return logits, cache

    def decode_step(self, params, cache, tokens, *, force: Optional[str] = None):
        """tokens: (B, 1) -> (logits (B, V), the same cache, updated)."""
        return self.prefill(params, {"tokens": tokens}, cache, force=force)

    def decode_slots(self, params, cache, tokens, slots, *,
                     force: Optional[str] = None):
        """Decode one token for each cache row in ``slots`` and no other.

        tokens: (n, 1); slots: (n,) row indices; each token goes at its row's
        ``cache_len``, which then grows by one (in place).  Returns logits
        (n, V)."""
        rows = torch.as_tensor(slots, device=tokens.device).long()
        positions = cache["cache_len"][rows].long()[:, None]
        step = CacheStep(rows=rows)
        if self.has_attn:
            kv = self._attn_cache(cache)["k"]
            step.block_tables = _page_tables(rows, kv.shape[-3], kv.shape[-4], tokens.device)
            # the keys K2 reads: the token's own is in the cache only when
            # it is written before the attention (inline)
            step.context_lens = (positions[:, 0]
                                 + int(self.cfg.kv_append == "inline")).int()
        x = params["embed"][tokens]
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
        """Random parameters on ``generator``'s device (``cuda`` when no
        generator is given: a fresh one seeded with 0), in the reference's
        tree: stacked encoder, decoder and cross-attention layers."""
        if generator is None:
            generator = torch.Generator(resolve_device(device)).manual_seed(0)
        device = generator.device
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
            p = _layer(enc, i)
            hn = L.apply_norm(cfg, x, p["norm1"])
            q, k, v = L.attn_qkv(cfg, p["attn"], hn, positions)
            ctx = ops.flash_attention(q, k, v, causal=False, force=force)
            x = x + L.attn_out(p["attn"], ctx.to(x.dtype))
            x = x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, x, p["norm2"]))
        return L.apply_norm(cfg, x, params["enc_final_norm"])

    def _cross_kv(self, params, enc_out):
        """Every decoder layer's cross-attention K and V of the encoder
        states: two (L, B, F, Hkv, D) tensors."""
        cps = [_layer(params["cross"], i)["attn"] for i in range(self.cfg.num_layers)]
        ks = [L._proj_heads(enc_out, cp["wk"]) for cp in cps]
        vs = [L._proj_heads(enc_out, cp["wv"]) for cp in cps]
        return torch.stack(ks), torch.stack(vs)

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
        Returns (loss, {"loss", "tokens"})."""
        cfg = self.cfg
        extra = set(batch) - {"tokens", "labels", "loss_mask", "frontend_embeds"}
        if extra:
            raise ValueError(f"unsupported inputs {sorted(extra)}: positions "
                             "always run from 0")
        enc_out = self.encode(params, batch["frontend_embeds"], force=force)
        ck, cv = self._cross_kv(params, enc_out)
        tokens, labels = batch["tokens"], batch["labels"].long()
        B, S = tokens.shape
        x = params["embed"][tokens] + params["pos_embed"][:S][None]
        positions = torch.arange(S, device=x.device).expand(B, S)
        crosses = [(_layer(params["cross"], i), (ck[i], cv[i])) for i in range(cfg.num_layers)]
        x, _ = _train_stack(cfg, ["attn"] * cfg.num_layers, params["decoder"], x, positions,
                            remat=remat, force=force, crosses=crosses)
        x = L.apply_norm(cfg, x, params["final_norm"])
        logp = torch.log_softmax((x @ params["embed"].T).float(), dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        mask = (torch.ones((B, S), dtype=torch.float32, device=x.device) if mask is None
                else mask.float())
        tokens_n = torch.clamp(mask.sum(), min=1.0)
        loss = torch.sum(-ll * mask) / tokens_n
        return loss, {"loss": loss.detach(), "tokens": mask.sum()}

    # ----------------------------------------------------------- serving --
    def init_cache(self, batch: int, cache_size: int, dtype=torch.bfloat16,
                   device=None, *, enc_frames: Optional[int] = None) -> Dict[str, Any]:
        """The decoder's self-attention cache, as :class:`TransformerLM`'s,
        and the cross-attention K/V of ``enc_frames`` frames (the encoder's
        ``max_source_positions`` by default) a row, padded to a whole number
        of K2's pages: ``cross_k``/``cross_v`` (L, B, F_pad, Hkv, D), zeros."""
        if cache_size % PAGE_SIZE:
            raise ValueError(f"cache_size {cache_size} must be a multiple of "
                             f"the page size {PAGE_SIZE}")
        device = resolve_device(device)
        cfg = self.cfg
        F = enc_frames or cfg.encoder.max_source_positions
        F_pad = -(-F // PAGE_SIZE) * PAGE_SIZE
        xk = torch.zeros((cfg.num_layers, batch, F_pad, cfg.num_kv_heads, cfg.head_dim),
                         dtype=dtype, device=device)
        return {"layers": block_cache(cfg, "attn", batch, cache_size, dtype, device,
                                      lead=(cfg.num_layers,)),
                "cross_k": xk, "cross_v": torch.zeros_like(xk), "cross_frames": F,
                "cache_len": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def _decoder(self, params, tokens, positions, cache, step: CacheStep, force):
        cfg = self.cfg
        pos = torch.clamp(positions, 0, cfg.max_seq_len - 1)
        x = params["embed"][tokens] + params["pos_embed"][pos]
        for i in range(cfg.num_layers):
            kv = {"k": cache["cross_k"][i], "v": cache["cross_v"][i],
                  "frames": cache["cross_frames"]}
            x = run_block(cfg, "attn", _layer(params["decoder"], i), x, positions,
                          _layer(cache["layers"], i), step=step, force=force,
                          cross=(_layer(params["cross"], i), kv))
        x = L.apply_norm(cfg, x[:, -1:, :], params["final_norm"])
        return (x @ params["embed"].T)[:, 0, :]

    def prefill(self, params, inputs, cache, *, force: Optional[str] = None):
        """The encoder over ``inputs["frontend_embeds"]`` (B, F, d) where
        given, its cross K/V written into every row of the cache, then the
        decoder over the T tokens at cache_len + arange(T) (in place);
        returns (last-position logits (B, V), the same cache)."""
        extra = set(inputs) - {"tokens", "frontend_embeds"}
        if extra:
            raise ValueError(f"unsupported inputs {sorted(extra)}: positions "
                             "always follow the cache length")
        tokens = inputs["tokens"]
        B, T = tokens.shape
        if "frontend_embeds" in inputs:
            fe = inputs["frontend_embeds"]
            if fe.shape[1] != cache["cross_frames"]:
                raise ValueError(f"{fe.shape[1]} frames for a cache of "
                                 f"{cache['cross_frames']}")
            ck, cv = self._cross_kv(params, self.encode(params, fe.to(params["embed"].dtype),
                                                        force=force))
            F = fe.shape[1]
            cache["cross_k"][:, :, :F] = ck.to(cache["cross_k"].dtype)
            cache["cross_v"][:, :, :F] = cv.to(cache["cross_v"].dtype)
        if T == 1:
            rows = torch.arange(B, device=tokens.device)
            return self.decode_slots(params, cache, tokens, rows, force=force), cache
        start = _prefill_start(cache, cache["layers"]["k"], T)
        positions = (start + torch.arange(T, device=tokens.device)).expand(B, T)
        logits = self._decoder(params, tokens, positions, cache, CacheStep(start=start), force)
        cache["cache_len"] += T
        return logits, cache

    def decode_step(self, params, cache, tokens, *, force: Optional[str] = None):
        """tokens: (B, 1) -> (logits (B, V), the same cache, updated)."""
        return self.prefill(params, {"tokens": tokens}, cache, force=force)

    def decode_slots(self, params, cache, tokens, slots, *,
                     force: Optional[str] = None):
        """As :meth:`TransformerLM.decode_slots`; the cross-attention reads
        the listed rows' cross K/V through K2, F keys each."""
        rows = torch.as_tensor(slots, device=tokens.device).long()
        positions = cache["cache_len"][rows].long()[:, None]
        kv, xk = cache["layers"]["k"], cache["cross_k"]
        n = rows.shape[0]
        step = CacheStep(
            rows=rows,
            block_tables=_page_tables(rows, kv.shape[-3], kv.shape[-4], tokens.device),
            context_lens=(positions[:, 0] + 1).int(),
            cross_tables=_page_tables(rows, xk.shape[-3], xk.shape[-4], tokens.device),
            cross_lens=torch.full((n,), cache["cross_frames"], dtype=torch.int32,
                                  device=tokens.device))
        logits = self._decoder(params, tokens, positions, cache, step, force)
        cache["cache_len"][rows] += 1
        return logits


def build_model(cfg: ModelConfig):
    if cfg.is_enc_dec:
        return EncDecLM(cfg)
    return TransformerLM(cfg)
