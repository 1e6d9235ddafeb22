"""Model building blocks in PyTorch: the dense, dropless-MoE, Mamba2 (SSD)
and RG-LRU (RecurrentGemma) subsets of ``repro.models.layers``.

Plain functions over explicit parameter dictionaries that keep the JAX
package's names and layouts (attention weights (d, H, Dh) and (H, Dh, d)), so
that :mod:`repro_torch.models.convert` copies parameters without renaming or
transposing.  Compute runs in the input type with fp32 norms, RoPE, softmax
and SSD recurrence, as in the reference.

Conventions: B batch, T query tokens, S KV length, H heads, Hkv KV heads,
D head_dim, d = d_model, F = d_ff; for SSD, H heads of P channels, state N.

:func:`attention`, :func:`causal_mask` and :func:`full_mask` are the
reference's dense, mask-based attention, kept for layer-level parity tests; the model attends
over its cache through :mod:`repro_torch.kernels.ops`.  The deferred KV
append attends over two segments of keys, the cache and the new chunk, each
through a kernel that also returns its log-sum-exp (:func:`attention_partial`:
K1), and merges them exactly (:func:`attention_merge`).  :func:`ssd_prefill`
runs its chunked scan through ``ops.ssd_scan`` (K3 on the card);
:func:`ssd_decode_step` has no kernel in the reference and stays plain
PyTorch.  :func:`moe` is the reference's dropless MoE; its two grouped
products lie outside any Pallas kernel in the reference
(``jax.lax.ragged_dot``) and stay PyTorch products here
(:func:`grouped_mm`).  :func:`moe_a2a` is the reference's expert-parallel
MoE over the ``torch.distributed`` ranks of the ambient mesh's "model"
axis (:func:`use_mesh`, :func:`ambient_mesh`; the mesh itself and the
weights' cut come from :mod:`repro_torch.launch.mesh`).  The dense layers
(:func:`attn_qkv`, :func:`attn_out`, :func:`mlp`, :func:`embed`,
:func:`unembed`), :func:`rglru`, the SSD and :func:`moe` run on a rank's
block of their weights wherever they are given one (:func:`tp_group`):
Megatron's tensor parallelism over the same ranks, the attention's on its
heads or on head_dim where the heads do not split (:class:`AttnHeads`), the
RG-LRU's on its width, the SSD's on its heads and the MoE's on its experts'
FFN width, where the columns a rank needs of a packed projection come from
the ranks that hold them (:func:`_fetch_columns`).  A training step on a
("data", "model") mesh also cuts the leaves over "data" (FSDP): the model
gathers each where it is used (:func:`gathered`), and its rows of the
batch are a block of the microbatch's (:func:`split_rows`).  Serving on a
mesh with batch axes ("data", or "pod" and "data") holds the MoE experts'
d over them, gathered where the MoE runs (:func:`moe`), and, where the
batch axes do not divide the batch, each rank's block of the KV sequence,
whose attention is merged over "data" (:func:`merge_blocks`); under
``kv_seq_shard`` the sequence is cut over "model" instead, and a decode
attends for every query head (``AttnHeads.whole_q``, ``whole_kv``) and
merges over "model".  Every collective goes through one of
:func:`_all_gather`, :func:`_all_reduce`, :func:`_reduce_scatter` and
:func:`_exchange` (and the optimizer's two all-reduces), which count it in
:data:`COLLECTIVES` (:func:`record_collective`).  :func:`rglru` runs
its fp32 recurrence as a chunked scan in plain PyTorch (:func:`rglru_scan`); the reference has no kernel for
it either (``jax.lax.associative_scan``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
import threading
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

from .config import ModelConfig

# Leaves the reference initialises in fp32 whatever the model's type
# (``repro.models.layers.ssd_params`` and ``moe_params``); conversions leave
# them in fp32.
FP32_LEAVES = frozenset({"A_log", "D", "dt_bias", "router", "log_lambda"})

# --------------------------------------------------------------------------
# initialisation helpers
# --------------------------------------------------------------------------


def dense_init(shape, generator: torch.Generator, *, in_axis: int = 0,
               lead=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated normal (±2σ) with σ = 1/sqrt(fan_in), as the reference.
    ``lead`` prepends stacking dimensions (the layer axis) that do not count
    towards the fan-in."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.empty(tuple(lead) + tuple(shape), dtype=dtype, device=device)
    if w.is_meta:   # nothing to draw: a meta tensor's first draw costs seconds of imports
        return _made(w)
    return _made(torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                                             generator=generator))


def embed_init(shape, generator: torch.Generator, *, dtype=torch.float32,
               device=None) -> torch.Tensor:
    w = torch.empty(shape, dtype=dtype, device=device)
    return _made(w if w.is_meta else w.normal_(0.0, 0.02, generator=generator))


def _fixed(make, shape, device) -> torch.Tensor:
    """``make()``, a leaf of fixed fp32 values, or an empty one of ``shape``
    on the meta device, where computing them costs seconds of imports."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return make()


_ON_INIT = threading.local()


@contextlib.contextmanager
def on_init(fn):
    """While the block runs, each leaf that :func:`dense_init` or
    :func:`embed_init` draws is handed to ``fn``, and what ``fn`` returns
    takes its place: a rank that keeps a block of each leaf
    (``launch.mesh.build_params``) frees the whole leaf before the next is
    drawn.  The draws themselves, and so the generator's stream, are
    unchanged."""
    prev = getattr(_ON_INIT, "fn", None)
    _ON_INIT.fn = fn
    try:
        yield
    finally:
        _ON_INIT.fn = prev


def _made(w):
    fn = getattr(_ON_INIT, "fn", None)
    return w if fn is None else fn(w)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def at_least_f32(x):
    """``x`` in fp32, or as it is where its type is wider (fp64): the
    plain training path of an SSD model then keeps fp64 throughout, for a
    witness of the exact gradient (``launch.train.witness``)."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x32 = at_least_f32(x)
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    y = x32 * inv
    if scale is not None:
        y = y * at_least_f32(scale)
    return y.to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm; with ``scale=bias=None`` this is OLMo's non-parametric LN."""
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def apply_norm(cfg: ModelConfig, x, params):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, params["scale"])
    if cfg.norm == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    if cfg.norm == "nonparametric_ln":
        return layer_norm(x, None, None)
    raise ValueError(cfg.norm)


def norm_params(cfg: ModelConfig, dtype, device=None, lead=()):
    shape = tuple(lead) + (cfg.d_model,)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    return {}  # non-parametric


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (B, T, H, D); positions: (B, T) int.  Rotates split halves
    ``[x1·cos − x2·sin, x2·cos + x1·sin]``, not interleaved pairs."""
    d_half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, d_half, dtype=torch.float32,
                                   device=x.device) / d_half)
    angles = positions[..., None].float() * freq        # (B,T,d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (dense reference, for the layer-level parity tests)
# --------------------------------------------------------------------------


def attention(q, k, v, mask, *, softmax_scale: Optional[float] = None,
              scores_dtype=torch.float32):
    """GQA attention.  q: (B,T,Hq,D); k,v: (B,S,Hkv,D); mask: (B,T,S) bool."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, T, Hkv, G, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k).to(scores_dtype) * scale
    neg = torch.finfo(scores_dtype).min / 2
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.tensor(neg, dtype=scores_dtype, device=q.device))
    probs = torch.softmax(scores.float(), dim=-1)
    probs = probs.to(scores_dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype), v)
    return out.reshape(B, T, Hq, D)


def attention_partial(q, k, v, *, q_offset: Optional[int] = None,
                      window: Optional[int] = None, force: Optional[str] = None):
    """One segment of keys for an online-softmax merge, through K1 (its plain
    version on the CPU): query t at key position ``q_offset + t`` (``S - T``
    by default), causal, with the optional window.  Returns (out (B,T,Hq,D)
    in q's type, normalised over the segment; lse (B,T,Hq) fp32, the
    log-sum-exp of each row's scaled scores, -inf where a row sees no key).

    The reference's ``attention_partial`` returns the unnormalised sum, the
    row max and the row sum (acc, m, l); out = acc / l and lse = m + log l
    carry the same information, and are what a flash kernel produces."""
    return ops.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset,
                               return_lse=True, force=force)


def attention_merge(segs, out_dtype, return_lse: bool = False):
    """Exact online-softmax combine of (out, lse) segments (the reference's
    ``attention_merge2`` over any number of them: a ring cache's keys before
    a chunk lie in up to two ranges of it): each segment weighs
    exp(lse - max lse), and out = Σ w·out / Σ w.  A segment that saw no key
    (lse = -inf) weighs 0; a row that none saw gives 0.  With
    ``return_lse`` also the merged lse, max lse + log Σ w (-inf where no
    segment saw a key)."""
    m = segs[0][1]
    for _, lse in segs[1:]:
        m = torch.maximum(m, lse)
    m = torch.where(torch.isinf(m), 0.0, m)                  # all empty
    num = den = 0.0
    for out, lse in segs:
        w = torch.exp(lse - m)
        num = num + out.float() * w[..., None]
        den = den + w
    empty = den == 0.0
    den = torch.where(empty, 1.0, den)
    out = (num / den[..., None]).to(out_dtype)
    if not return_lse:
        return out
    return out, torch.where(empty, -math.inf, m + torch.log(den))


def causal_mask(q_pos, kv_pos, window: Optional[int] = None):
    """q_pos: (B,T), kv_pos: (B,S) (−1 marks invalid KV slots) -> (B,T,S)."""
    m = kv_pos[:, None, :] <= q_pos[:, :, None]
    m &= kv_pos[:, None, :] >= 0
    if window is not None:
        m &= q_pos[:, :, None] - kv_pos[:, None, :] < window
    return m


def full_mask(q_pos, kv_pos):
    """Bidirectional (encoder) mask: only invalid slots (kv_pos < 0) masked."""
    B, T = q_pos.shape
    return (kv_pos[:, None, :] >= 0).expand(B, T, kv_pos.shape[1])


# --------------------------------------------------------------------------
# attention block params + apply
# --------------------------------------------------------------------------


def attn_params(cfg: ModelConfig, generator: torch.Generator, dtype, device=None,
                lead=()):
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {
        "wq": dense_init((cfg.d_model, cfg.num_heads, cfg.head_dim), generator, **kw),
        "wk": dense_init((cfg.d_model, cfg.num_kv_heads, cfg.head_dim), generator, **kw),
        "wv": dense_init((cfg.d_model, cfg.num_kv_heads, cfg.head_dim), generator, **kw),
        "wo": dense_init((cfg.num_heads, cfg.head_dim, cfg.d_model), generator,
                         in_axis=1, **kw),
    }
    if cfg.qkv_bias:
        zkw = dict(dtype=dtype, device=device)
        lead = tuple(lead)
        p["bq"] = torch.zeros(lead + (cfg.num_heads, cfg.head_dim), **zkw)
        p["bk"] = torch.zeros(lead + (cfg.num_kv_heads, cfg.head_dim), **zkw)
        p["bv"] = torch.zeros(lead + (cfg.num_kv_heads, cfg.head_dim), **zkw)
    return p


def _proj_heads(x, w):
    """einsum("btd,dhk->bthk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


# bytes this process received through the gathers and exchanges of a
# tensor-parallel rank, by what they moved: "head_dim" (the attention's
# projections and cache on head_dim), "rglru" (the RG-LRU's conv'd input),
# "ssd" (the SSD's packed columns), "moe_ffn" (the experts' gate and up
# columns), "fsdp" (a training rank's blocks of the leaves cut over
# "data", gathered where they are used), "experts" (a serving rank's
# blocks of the experts' d, gathered over the batch axes), "merge" (each
# "data" rank's attention over its block of the KV sequence), "seq_shard"
# (under ``kv_seq_shard``, the KV sequence over "model": the query heads
# and the new token's KV heads gathered to every head, and each "model"
# rank's attention over its block merged) and "kv_prefix" (the KV blocks a
# later prefill chunk gathers over the axis that cuts the sequence); read
# and reset by the caller (``launch.parallel``, ``launch.train``)
GATHERED: collections.Counter = collections.Counter()


@dataclass
class AttnHeads:
    """How a rank holds one attention layer, read from its projections'
    shapes (``launch.mesh.shard_params`` cuts them by the serve rules):

    * every projection whole (``group`` None), or
    * ``wq``/``wo`` on the query heads or, where they do not split over the
      "model" ranks, on head_dim (``q_dh``: the rank then attends for every
      query head and keeps its block of the context's head_dim for its rows
      of ``wo``), and
    * ``wk``/``wv`` on the KV heads or on head_dim (``kv_dh``: the rank's
      cache holds its block of head_dim of every KV head).

    Attention needs whole heads, so a head_dim block is gathered over
    "model" (:func:`attn_qkv`, :meth:`gathered`).  Rank m's query heads
    are [m·hq, (m+1)·hq) of the Hq (all of them where ``q_dh``); ``kv_sel``
    picks, from the KV heads that k holds, those heads' KV heads in the
    order K1 and K2 pair them (query head i with KV head i // (hq / n) of n):
    None where that is all of them, else the slice of them that the rank's
    queries read evenly.  ``q_block`` and ``kv_block`` are the slices of the
    whole query and KV heads that ``wq`` and ``wk`` hold where they are on
    heads (None where whole or on head_dim): a cache that holds every KV
    head whole (the KV sequence over "model", ``kv_seq_shard``) is read
    through :meth:`over_whole`, and such a decode attends for every query
    head (:meth:`whole_q`, :meth:`whole_kv`, :meth:`own_q`)."""

    group: Any
    rank: int
    tp: int
    head_dim: int
    q_dh: bool
    kv_dh: bool
    kv_sel: Any
    q_block: Any = None
    kv_block: Any = None

    def dh_block(self, t):
        """This rank's block of the last dimension (head_dim) of ``t``."""
        n = self.head_dim // self.tp
        return t.narrow(-1, self.rank * n, n)

    def cached(self, k):
        """What this rank's cache keeps of ``k`` (.., KV heads, D)."""
        return self.dh_block(k) if self.kv_dh else k

    def attended(self, k):
        """The KV heads of ``k`` (.., KV heads, D) this rank's queries read,
        dense past the batch dimension where they are not all of them, as
        K1 and K2 take them."""
        return k if self.kv_sel is None else k[..., self.kv_sel, :].contiguous()

    def gathered(self, kc):
        """The attended KV heads, whole, of a block of this rank's cache
        (.., KV heads, D or its block of D): its head_dim blocks gathered
        over "model" where the cache is on head_dim (contiguous)."""
        if self.kv_dh:
            GATHERED["head_dim"] += kc.numel() * kc.element_size() * (self.tp - 1)
            kc = _all_gather(kc, kc.dim() - 1, self.group)
        return self.attended(kc)

    def over_whole(self) -> "AttnHeads":
        """How this rank's queries read a cache of every KV head whole: no
        gather, and the KV heads they read picked from all of them."""
        sel = self.kv_sel
        if self.kv_block is not None:
            base = self.kv_block.start
            sel = (self.kv_block if sel is None
                   else slice(base + sel.start, base + sel.stop))
        return dataclasses.replace(self, kv_dh=False, kv_block=None, kv_sel=sel)

    def _gather(self, t, dim: int):
        GATHERED["seq_shard"] += t.numel() * t.element_size() * (self.tp - 1)
        return _all_gather(t, dim, self.group)

    def whole_kv(self, k):
        """Every KV head, whole, of the rank's ``k`` (.., its KV heads, D
        or its block of D): its block gathered over "model"
        (``GATHERED["seq_shard"]``), or ``k`` itself where it holds them."""
        if k.shape[-1] != self.head_dim:
            return self._gather(k, k.dim() - 1)
        if self.kv_block is not None:
            return self._gather(k, k.dim() - 2)
        return k

    def whole_q(self, q):
        """Every query head of the rank's ``q`` (.., its query heads, D):
        gathered over "model" where ``wq`` is on heads."""
        return q if self.q_block is None else self._gather(q, q.dim() - 2)

    def own_q(self, ctx):
        """The rank's query heads of ``ctx`` (.., every query head, D)."""
        return ctx if self.q_block is None else ctx[..., self.q_block, :]


@functools.lru_cache(maxsize=None)
def _whole_heads(head_dim: int) -> AttnHeads:
    return AttnHeads(group=None, rank=0, tp=1, head_dim=head_dim, q_dh=False, kv_dh=False,
                     kv_sel=None)


def attn_heads(cfg: ModelConfig, p) -> AttnHeads:
    """:class:`AttnHeads` of the attention parameters ``p`` (a rank's blocks
    or the whole layer).  Raises where the rank's query heads would read
    their KV heads unevenly, which K1 and K2 cannot pair."""
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hq, dq = p["wq"].shape[-2:]
    hk, dk = p["wk"].shape[-2:]
    group = tp_group(hq * dq, Hq * D)
    if group is None:
        group = tp_group(hk * dk, Hkv * D)
    if group is None:
        return _whole_heads(D)
    m, tp = _rank_and_size(group)
    G = Hq // Hkv
    q0, k0 = (m * hq if hq != Hq else 0), (m * hk if hk != Hkv else 0)
    if q0 % G == 0 and hq % G == 0:
        n = hq // G                     # whole groups of G query heads
    elif G % hq == 0:
        n = 1                           # a part of one KV head's group
    else:
        raise ValueError(f"query heads {q0}..{q0 + hq - 1} of {Hq} read their KV heads "
                         f"(groups of {G}) unevenly")
    first = q0 // G - k0
    if first < 0 or first + n > hk:
        raise ValueError(f"query heads {q0}..{q0 + hq - 1} of {Hq} need KV heads "
                         f"{first}..{first + n - 1} counted from {k0}, not among the {hk} "
                         "a rank holds")
    sel = None if (first, n) == (0, hk) else slice(first, first + n)
    return AttnHeads(group=group, rank=m, tp=tp, head_dim=D, q_dh=dq != D, kv_dh=dk != D,
                     kv_sel=sel, q_block=slice(q0, q0 + hq) if hq != Hq else None,
                     kv_block=slice(k0, k0 + hk) if hk != Hkv else None)


def attn_project(p, x, name: str, heads: AttnHeads, *, bias: bool = True, whole: bool = True):
    """``x @ p["w" + name]`` (B, T, heads, D): the rank's block of the
    projection, plus the same block of the replicated bias ``b<name>``
    where there is one and ``bias``; a head_dim block is gathered over
    "model" into whole heads unless ``whole`` is False."""
    w = p["w" + name]
    y = _proj_heads(x, w)
    b = p.get("b" + name) if bias else None
    if b is not None:
        if heads.group is not None:
            b = _Copy.apply(b, heads.group)
            for dim in (-2, -1):
                if w.shape[dim] != b.shape[dim]:
                    b = _own_block(b, dim, w.shape[dim], heads.group)
        y = y + b
    if whole and w.shape[-1] != heads.head_dim:
        GATHERED["head_dim"] += y.numel() * y.element_size() * (heads.tp - 1)
        y = _Gather.apply(y, y.dim() - 1, heads.group)
        if name != "q" and not heads.q_dh:
            # whole K/V heads that each rank's own query heads read: their
            # gradient is summed over "model" before each keeps its block
            y = _Copy.apply(y, heads.group)
    return y


def attn_qkv(cfg: ModelConfig, p, x, positions, heads: Optional[AttnHeads] = None):
    """q, k, v (B, T, heads, D) of x (B, T, d), each over the whole head_dim
    D.  On a rank (:class:`AttnHeads`) each projection is its block, plus
    the bias's block, and a head_dim block is gathered over "model" before
    RoPE, which rotates the halves of the whole head_dim: q holds the
    rank's query heads (every one where ``wq`` is on head_dim), k and v the
    KV heads of its weights (every one where ``wk`` is on head_dim), of
    which ``AttnHeads.cached`` and ``attended`` take what the cache keeps
    and what the queries read.  x enters through ``_Copy``.  ``heads`` is
    :func:`attn_heads` of ``p``, where the caller has it."""
    if heads is None:
        heads = attn_heads(cfg, p)
    if heads.group is not None:
        x = _Copy.apply(x, heads.group)
    q, k, v = (attn_project(p, x, name, heads) for name in "qkv")
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(cfg: ModelConfig, p, ctx):
    """einsum("bthk,hkd->btd") as one matmul over the flattened heads.  A
    rank's block of ``wo`` gives a partial sum, reduced over "model": its
    query heads' rows, or, on head_dim, its block of every head's D rows,
    which take the same block of the whole-head context."""
    h, k, d = p["wo"].shape[-3:]
    group = tp_group(h * k, cfg.num_heads * cfg.head_dim)
    if k != ctx.shape[-1]:          # the same on every rank: _Split keeps its gradient whole
        ctx = _Split.apply(ctx, ctx.dim() - 1, group)
    y = ctx.flatten(-2) @ p["wo"].reshape(h * k, d)
    return _reduce_partial(y, group)


# --------------------------------------------------------------------------
# MLP (dense)
# --------------------------------------------------------------------------


def mlp_params(cfg: ModelConfig, generator: torch.Generator, dtype, device=None,
               d_ff: Optional[int] = None, lead=()):
    d_ff = d_ff or cfg.d_ff
    kw = dict(dtype=dtype, device=device, lead=lead)
    if cfg.mlp_act == "swiglu":
        return {
            "wi": dense_init((cfg.d_model, d_ff), generator, **kw),
            "wg": dense_init((cfg.d_model, d_ff), generator, **kw),
            "wo": dense_init((d_ff, cfg.d_model), generator, **kw),
        }
    return {
        "wi": dense_init((cfg.d_model, d_ff), generator, **kw),
        "wo": dense_init((d_ff, cfg.d_model), generator, **kw),
    }


def mlp(cfg: ModelConfig, p, x):
    """The dense MLP; a rank that holds its block of F (``wi``/``wg``
    columns, ``wo`` rows) takes x through ``_Copy`` and reduces its partial
    output over "model"."""
    group = tp_group(p["wi"].shape[-1], cfg.d_ff)
    if group is not None:
        x = _Copy.apply(x, group)
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return _reduce_partial(h @ p["wo"], group)


# --------------------------------------------------------------------------
# embeddings (vocabulary-parallel on a rank's block of the vocabulary)
# --------------------------------------------------------------------------


def embed(cfg: ModelConfig, w, tokens):
    """The rows of ``w`` (V, d) for ``tokens``.  A rank that holds its block
    of V / tp rows looks up the tokens inside it, zeros the rest and sums
    over "model": one rank gives each token its row, so the sum is exact."""
    group = tp_group(w.shape[0], cfg.vocab_size)
    if group is None:
        return w[tokens]
    V_loc = w.shape[0]
    local = tokens - dist.get_rank(group) * V_loc
    inside = (local >= 0) & (local < V_loc)
    x = torch.where(inside[..., None], w[local.clamp(0, V_loc - 1)],
                    torch.zeros((), dtype=w.dtype, device=w.device))
    return _reduce_partial(x, group)


def unembed(cfg: ModelConfig, params, x):
    """Logits x @ unembed (or @ embedᵀ where tied); a rank's block of the
    vocabulary gives its block of the logits, gathered over "model"."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    group = tp_group(w.shape[-1], cfg.vocab_size)
    if group is None:
        return x @ w
    return _Gather.apply(_Copy.apply(x, group) @ w, x.dim() - 1, group)


# --------------------------------------------------------------------------
# Mixture of Experts: sort-based dispatch, grouped products (dropless)
# --------------------------------------------------------------------------


def moe_params(cfg: ModelConfig, generator: torch.Generator, dtype, device=None, lead=()):
    """``router`` (d, E) in fp32 whatever ``dtype``; ``w_in`` (E, d, n_in·F_e)
    and ``w_out`` (E, F_e, d) with their fan-in on axis 1 (after ``lead``)."""
    moe_cfg = cfg.moe
    n_in = 2 if cfg.mlp_act == "swiglu" else 1
    E, F_e = moe_cfg.num_experts, moe_cfg.d_ff_expert
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "router": dense_init((cfg.d_model, E), generator, dtype=torch.float32,
                             device=device, lead=lead),
        "w_in": dense_init((E, cfg.d_model, n_in * F_e), generator, in_axis=1, **kw),
        "w_out": dense_init((E, F_e, cfg.d_model), generator, in_axis=1, **kw),
    }


def moe_route(cfg: ModelConfig, p, xf):
    """Router of :func:`moe`: fp32 logits ``xf @ router``, their softmax, and
    its top-k, renormalised.  xf: (n, d) -> probs (n, E), gate (n, K) and the
    expert ids idx (n, K), both in descending order of probability."""
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, gate / gate.sum(dim=-1, keepdim=True), idx


def grouped_mm(x, w, group_sizes, *, force: Optional[str] = None):
    """``jax.lax.ragged_dot``: rows of ``x`` (m, k) sorted by group, group g's
    ``group_sizes[g]`` rows times ``w[g]`` (G, k, n) -> (m, n) in x's type.

    On the card it is one ``torch._grouped_mm`` call whose group ends are the
    cumulative sizes on the device, so no host read waits on the router; its
    plain version, :func:`grouped_mm_loop`, serves the CPU and
    ``force="plain"``; a meta tensor (the dry-run) takes the grouped call,
    whose output shape needs no sizes.  Rows past the last group are not
    computed."""
    if ops._use_kernel(x, force) or x.is_meta:
        offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
        if x.is_meta:
            # a meta tensor has shapes only: the loop would read the sizes,
            # and the grouped call's shape function takes bf16 alone
            return torch._grouped_mm(x.to(torch.bfloat16), w.to(torch.bfloat16),
                                     offs=offs).to(x.dtype)
        return torch._grouped_mm(x, w, offs=offs)
    return grouped_mm_loop(x, w, group_sizes)


def grouped_mm_loop(x, w, group_sizes):
    """The plain version of :func:`grouped_mm`: one product per expert over
    its rows, the sizes read on the host."""
    out = x.new_empty((x.shape[0], w.shape[-1]))
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        out[start:start + size] = x[start:start + size] @ w[g]
        start += size
    return out


def _combine(pairs, gate):
    """Each token's K expert outputs ``pairs`` (n·K, d), in the order of its
    choices, weighted by ``gate`` (n, K) and summed: (n, d) in their type.
    A sum over a fixed axis, not the reference's scatter-add, whose
    ``index_add_`` on the card adds in whatever order the atomics land and
    so rounds a bf16 row differently from run to run (ROADMAP C1)."""
    n, K = gate.shape
    return (pairs.view(n, K, -1) * gate[..., None].to(pairs.dtype)).sum(dim=1)


def moe(cfg: ModelConfig, p, x, *, force: Optional[str] = None):
    """Dropless MoE, as the reference: route, sort the (token, choice) pairs
    by expert (stable), two grouped products, then each token's outputs
    weighted by the gates and summed (:func:`_combine`).  x: (B, T, d) ->
    (y (B, T, d), {"moe_aux_loss", "expert_load"}), the Switch-style
    load-balance loss and each expert's share of the n·K choices.
    ``force="plain"`` runs the per-expert loop.

    A rank that holds its block of every expert's FFN width (the serve
    rules where the experts do not divide over "model": ``w_in``'s packed
    [gate | up] columns and ``w_out``'s rows, each cut into contiguous
    blocks) runs every token through it: the replicated router, its block
    of ``w_in``, then one exchange (:func:`_fetch_columns`,
    ``GATHERED["moe_ffn"]``) that brings it the gate and up columns of its
    own rows of ``w_out`` from the ranks that computed them, and its partial
    output reduced over "model" in fp32.  A rank that holds its block of
    the experts (the rules where they divide over "model") runs
    :func:`_moe_expert_sharded`.  The statistics are every token's on every
    rank, and every row's of the microbatch where a training step cuts its
    rows over "data" (:func:`_router_stats`).  A serving rank that holds
    its block of the experts' d first gathers them over the batch axes
    (:func:`gather_experts`)."""
    moe_cfg = cfg.moe
    E, K = moe_cfg.num_experts, moe_cfg.top_k
    B, T, d = x.shape
    n = B * T
    xf = x.reshape(n, d)
    p = gather_experts(cfg, p, x)
    E_loc = p["w_in"].shape[-3]
    if E_loc != E:                   # this rank's experts: the rules where they divide
        group = tp_group(E_loc, E)
        p = {**p, "router": _Copy.apply(p["router"], group)}   # its gradient summed over "model"
        return _moe_expert_sharded(cfg, p, x, group, dist.get_rank(group), E // E_loc, force)
    F_e, F_loc = moe_cfg.d_ff_expert, p["w_out"].shape[-2]
    group, tp = tp_group(F_loc, F_e), F_e // F_loc
    if group is not None:
        xf = _Copy.apply(xf, group)
        p = {**p, "router": _Copy.apply(p["router"], group)}   # its gradient summed over "model"
    probs, gate, idx = moe_route(cfg, p, xf)
    flat_expert = idx.reshape(-1)                                     # (n*K,)
    sort_idx = torch.argsort(flat_expert, stable=True)
    token_of = sort_idx // K
    xs = xf[token_of]                                                 # (n*K, d)
    # a scatter, not bincount, which reads the largest id on the host
    group_sizes = torch.zeros(E, dtype=torch.int32, device=x.device).index_add_(
        0, flat_expert, torch.ones_like(flat_expert, dtype=torch.int32))

    h = grouped_mm(xs, p["w_in"], group_sizes, force=force)          # (n*K, n_in*F_e)
    if cfg.mlp_act == "swiglu":
        if group is not None:        # the gate and up columns of this rank's rows of w_out
            h = _fetch_columns(h, [[(j * F_loc, (j + 1) * F_loc),
                                    (F_e + j * F_loc, F_e + (j + 1) * F_loc)]
                                   for j in range(tp)], group, "moe_ffn")
        hi, hg = torch.chunk(h, 2, dim=-1)
        h = F.silu(hi) * hg
    else:                            # one block of F_e columns: the rows of w_out
        h = F.gelu(h, approximate="tanh")
    ys = grouped_mm(h, p["w_out"], group_sizes, force=force)         # (n*K, d)
    out = _combine(torch.empty_like(ys).index_copy(0, sort_idx, ys), gate)  # in pair order

    me, ce = _router_stats(probs, group_sizes.float(), K)
    aux_loss = E * torch.sum(me * ce)
    if group is not None:
        out = _reduce_partial(out, group)
        # every rank has the whole loss: a 1/tp share a rank sums to one
        # loss's gradient over the ranks (the router's _Copy)
        aux_loss = _Reduce.apply(aux_loss / tp, group)
    return out.reshape(B, T, d), {"moe_aux_loss": aux_loss, "expert_load": ce}


# --------------------------------------------------------------------------
# Expert-parallel MoE: capacity-bounded all-to-all over the "model" ranks
# --------------------------------------------------------------------------
#
# Every rank of a "model" group computes the same thing outside the MoE and
# ends with the same loss, so each collective's gradient is the one that
# keeps the ranks' gradients of replicated tensors whole (the rule of
# Megatron's sequence parallelism): a replicated tensor cut into the rank's
# block gathers the gradient blocks back (_Split); blocks gathered into a
# replicated tensor each take their own block of its gradient (_Gather);
# partial sums reduced into a replicated tensor each take its whole gradient
# (_Reduce); a replicated tensor fed into per-rank partial work sums its
# gradient over the ranks (_Copy).  The library's autograd all_gather and
# all_reduce sum the ranks' gradients in every case, which would count the
# one loss once a rank.  The exchanges themselves go through
# ``torch.distributed.nn.functional.all_to_all_single``, whose gradient is
# the reverse exchange.  The router, which every rank holds whole but runs
# on its own tokens only, would end with a partial gradient on each rank, so
# it enters the MoE through _Copy: its gradient is summed over "model" in
# the backward pass, before anything compares or uses it.


_AMBIENT = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh of this thread while
    the block runs: the reference's ``with mesh:``."""
    stack = _AMBIENT.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def ambient_mesh():
    """The innermost mesh of :func:`use_mesh` on this thread, or None: the
    reference's ``_ambient_mesh()``."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def model_coordinate(mesh) -> Tuple[int, int]:
    """(this rank's "model" coordinate, the "model" size) of ``mesh``, or
    (0, 1) without a "model" axis."""
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return 0, 1
    sub = mesh["model"]
    return sub.get_local_rank(), sub.size()


def data_coordinate(mesh) -> Tuple[int, int]:
    """(this rank's "data" coordinate, the "data" size) of ``mesh``, or
    (0, 1) without a "data" axis."""
    if mesh is None or "data" not in (mesh.mesh_dim_names or ()):
        return 0, 1
    sub = mesh["data"]
    return sub.get_local_rank(), sub.size()


# the name of a pod mesh's flattened batch axes ("pod", "data"), which
# ``launch.mesh.device_mesh`` makes
BATCH_DIM = "pod_data"


def axis_coordinate(mesh, axis: str) -> Tuple[int, int]:
    """(this rank's coordinate on ``axis``, "data" or "model", its size)."""
    return model_coordinate(mesh) if axis == "model" else data_coordinate(mesh)


def batch_coordinate(mesh) -> Tuple[int, int]:
    """(this rank's coordinate on the batch axes, their size) of ``mesh``:
    on a ("pod", "data", "model") mesh pod-major, p·D + d of P·D, the order
    of the reference's ``PartitionSpec(("pod", "data"))``; else
    :func:`data_coordinate`."""
    if mesh is None or "pod" not in (mesh.mesh_dim_names or ()):
        return data_coordinate(mesh)
    sub = mesh[BATCH_DIM]
    return sub.get_local_rank(), sub.size()


def batch_group(mesh):
    """The process group of ``mesh``'s batch axes: "data", or ("pod",
    "data") flattened on a pod mesh."""
    if "pod" in (mesh.mesh_dim_names or ()):
        return mesh[BATCH_DIM].get_group()
    return mesh.get_group("data")


@contextlib.contextmanager
def split_rows(group):
    """While the block runs, the batch rows the model is given are this
    rank's block of the rows that the ranks of ``group`` (a training step's
    batch-axes ranks, ``models.optim``) share: the loss's token sums and counts
    and the MoE's router statistics are summed over ``group``, so that every
    rank has the loss of all the rows.  ``None``: the rows are all of them."""
    stack = _AMBIENT.__dict__.setdefault("rows", [])
    stack.append(group)
    try:
        yield group
    finally:
        stack.pop()


def row_group():
    """The innermost group of :func:`split_rows` on this thread, or None."""
    stack = getattr(_AMBIENT, "rows", None)
    return stack[-1] if stack else None


def tp_group(local: int, whole: int):
    """The ambient mesh's "model" group where a rank holds ``local`` of a
    dimension of ``whole`` (its block: ``launch.mesh.shard_params``), None
    where it holds all of it.  A block that is not one "model" rank's share
    raises."""
    if local == whole:
        return None
    mesh = ambient_mesh()
    _, tp = model_coordinate(mesh)
    if tp == 1 or local * tp != whole:
        raise ValueError(f"a block of {local} of {whole} needs {whole // local} 'model' "
                         f"ranks; the ambient mesh has {tp}")
    return mesh.get_group("model")


def _own_block(x, dim: int, n: int, group):
    """This rank's block of ``n`` along ``dim`` of a replicated tensor."""
    return x.narrow(dim, dist.get_rank(group) * n, n)


def _reduce_partial(y, group):
    """The ranks' partial sums ``y`` summed over ``group`` in fp32 and cast
    back, so that the sum rounds once; ``y`` itself without a group."""
    if group is None:
        return y
    return _Reduce.apply(y.float(), group).to(y.dtype)


def _rank_and_size(group):
    return dist.get_rank(group), dist.get_world_size(group)


# the collectives this process issued, by the kinds of the reference's
# ``repro.launch.hlo_cost``: COLLECTIVES[kind] the bytes of their results
# (an all-gather's whole gathered tensor, a reduce-scatter's block) and
# COLLECTIVES[kind + " ops"] their count, one a call.  Every collective of
# the model and the optimizer goes through :func:`record_collective`, on
# the real ranks and on the meta device alike (``launch.rank_cost``); read
# with :func:`collective_census`, reset by the caller
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
COLLECTIVES: collections.Counter = collections.Counter()


def record_collective(kind: str, result) -> None:
    """Count one collective of ``kind`` whose result is ``result``."""
    COLLECTIVES[kind] += result.numel() * result.element_size()
    COLLECTIVES[kind + " ops"] += 1


def collective_census() -> dict:
    """{"bytes_by_op": {kind: result bytes}, "ops_by_op": {kind: calls}}
    of :data:`COLLECTIVES`, every kind of :data:`COLLECTIVE_KINDS` present."""
    return {"bytes_by_op": {k: COLLECTIVES[k] for k in COLLECTIVE_KINDS},
            "ops_by_op": {k: COLLECTIVES[k + " ops"] for k in COLLECTIVE_KINDS}}


def _all_gather(x, dim: int, group):
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order, gathered into the blocks of one tensor."""
    x = x.contiguous()
    blocks = x.new_empty((dist.get_world_size(group),) + tuple(x.shape))
    dist.all_gather(list(blocks.unbind(0)), x, group=group)
    dim %= x.dim()
    out = blocks.movedim(0, dim).flatten(dim, dim + 1)
    record_collective("all-gather", out)
    return out


def _all_reduce(x, group):
    x = x.clone()
    dist.all_reduce(x, group=group)
    record_collective("all-reduce", x)
    return x


class _Split(torch.autograd.Function):
    """This rank's block of a replicated tensor along ``dim``; the gradient
    gathers every rank's block."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        rank, n = _rank_and_size(group)
        return x.chunk(n, dim)[rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    """Every rank's block along ``dim`` gathered into one replicated tensor;
    the gradient keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        rank, n = _rank_and_size(ctx.group)
        return g.chunk(n, ctx.dim)[rank].contiguous(), None, None


class _Reduce(torch.autograd.Function):
    """The sum over the ranks of their partial tensors; the gradient passes
    unchanged to each rank's part."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """A replicated tensor into per-rank partial work; the gradient is the
    sum over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _reduce_scatter(x, dim: int, group):
    """The sum of ``x`` over ``group``, cut along ``dim`` into as many
    equal blocks as ranks: this rank's block."""
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // dist.get_world_size(group),) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    record_collective("reduce-scatter", out)
    return out.movedim(0, dim).contiguous()


# --------------------------------------------------------------------------
# FSDP over "data": a rank's block of a leaf, gathered where a layer uses it
# --------------------------------------------------------------------------
#
# The "train" rules cut a second dimension of most matrices over "data"
# (``launch.mesh.model_placements(..., mode="train")``).  A training step
# hands the model such a leaf as a DataBlock (``models.optim``), and the
# model gathers it where a layer uses it (:func:`gathered`): a block's
# leaves inside its remat region, so that the backward pass gathers them
# again, the embeddings where they are used.  The gather's gradient is not
# _Gather's: the "data" ranks run different rows, so each rank's gradient
# of the gathered leaf is a partial sum, which is summed over "data" and
# cut back to the rank's block.

# bytes this process moved in the reductions of gradients over "data", by
# what they reduced: "fsdp" the reduce-scatters of the gathered leaves'
# gradients (the (D - 1) blocks it sends of each), "replicated" the
# all-reduce of the other leaves' (2 (D - 1) / D of each, a ring's share);
# the gathers themselves count in GATHERED["fsdp"]
REDUCED: collections.Counter = collections.Counter()


class DataBlock:
    """A rank's block of a leaf along ``dim`` (from the right), cut over the
    "data" ranks of ``group``: what :func:`gathered` turns into the leaf a
    layer runs."""

    __slots__ = ("block", "dim", "group")

    def __init__(self, block, dim: int, group):
        self.block, self.dim, self.group = block, dim, group


def gathered(tree):
    """``tree`` (a leaf, or dictionaries and lists of them) with every
    :class:`DataBlock` gathered over its "data" ranks (:class:`_GatherData`);
    any other leaf as it is."""
    if isinstance(tree, DataBlock):
        return _GatherData.apply(tree.block, tree.dim, tree.group)
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gathered(v) for v in tree]
    return tree


class _GatherData(torch.autograd.Function):
    """Every "data" rank's block along ``dim`` gathered into the leaf; the
    gradient is summed over the ranks and each keeps its own block (a
    reduce-scatter).  The bytes received count in ``GATHERED[what]``."""

    @staticmethod
    def forward(ctx, x, dim, group, what="fsdp"):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        GATHERED[what] += x.numel() * x.element_size() * (n - 1)
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        REDUCED["fsdp"] += g.numel() * g.element_size() * (n - 1) // n
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None


def gather_experts(cfg: ModelConfig, p, x):
    """The MoE parameters ``p`` with the experts' ``w_in`` and ``w_out``
    whole in d where a serving rank holds its block of it (the serve rules'
    ``moe_data``: ``w_in``'s dimension -2 and ``w_out``'s -1 over the batch
    axes, ``launch.mesh.shard_params``), for this call alone, so that a
    rank keeps only its block at rest; ``p`` itself where d is whole.

    Only the rank's experts that a token of ``x`` (B, T, d) chooses, on any
    rank of the batch axes (a sum over them), are gathered over the batch
    axes (:class:`_GatherData`, forward only here; ``GATHERED["experts"]``);
    the others are left zero, which no token reads.  A decode's few tokens
    choose few of them; a prefill's, every one."""
    d_loc = p["w_in"].shape[-2]
    if d_loc == cfg.d_model:
        return p
    mesh = ambient_mesh()
    _, n = batch_coordinate(mesh)
    if d_loc * n != cfg.d_model:
        raise ValueError(f"a block of {d_loc} of the experts' d {cfg.d_model} needs "
                         f"{cfg.d_model // d_loc} ranks on the batch axes; the ambient mesh "
                         f"has {n}")
    group = batch_group(mesh)
    E, E_loc = cfg.moe.num_experts, p["w_in"].shape[-3]
    first = 0 if E_loc == E else model_coordinate(mesh)[0] * E_loc
    idx = moe_route(cfg, p, x.reshape(-1, x.shape[-1]))[2].reshape(-1)
    chosen = torch.zeros(E, dtype=torch.int32, device=x.device).index_fill_(0, idx, 1)
    keep = _kept_experts(_all_reduce(chosen[first:first + E_loc], group))
    out = dict(p)
    for name, dim in (("w_in", -2), ("w_out", -1)):
        w = p[name]
        if len(keep) == E_loc:
            out[name] = _GatherData.apply(w, dim, group, "experts")
            continue
        whole = list(w.shape)
        whole[dim] *= n
        out[name] = w.new_zeros(whole)
        if len(keep):
            out[name][keep] = _GatherData.apply(w[keep], dim, group, "experts")
    return out


# how many of its experts each call of gather_experts gathered, in call
# order, appended on every run and reset by the caller; a run on the meta
# device, where no token routes, gathers EXPERTS_REPLAY's counts in turn
# where given (``launch.rank_cost`` replays what real ranks recorded), else
# every expert
EXPERTS_KEPT: list = []
EXPERTS_REPLAY: list = []


def _kept_experts(chosen):
    """The indices of the rank's experts that some token chose (``chosen``
    (E_loc,) counts them), read on the host."""
    if chosen.is_meta:
        n = EXPERTS_REPLAY.pop(0) if EXPERTS_REPLAY else chosen.shape[0]
        return torch.arange(n, device=chosen.device)
    keep = chosen.nonzero()[:, 0]
    EXPERTS_KEPT.append(len(keep))
    return keep


def merge_blocks(out, lse, group, what: str = "merge"):
    """The attention of each rank of ``group`` over its block of the KV
    sequence, merged: the "data" ranks' of a context-parallel decode, or
    the "model" ranks' under ``kv_seq_shard``.  Every rank's (out (n, 1,
    Hq, D), lse (n, 1, Hq)) is gathered over ``group`` in fp32 (out itself
    is the rank's fp32 merge of its runs) and combined exactly by
    :func:`attention_merge` in the order of the ranks' coordinates on the
    group's axis, so every rank gets the same result, bit for bit, from run
    to run.  A block that saw no key (lse = -inf) weighs 0.  Returns (n, 1,
    Hq, D) in fp32; ``GATHERED[what]`` counts the bytes received."""
    n = dist.get_world_size(group)
    both = torch.cat([out.float(), lse.float()[..., None]], -1)
    GATHERED[what] += both.numel() * both.element_size() * (n - 1)
    parts = _all_gather(both, 0, group).chunk(n, 0)
    return attention_merge([(part[..., :-1], part[..., -1]) for part in parts], torch.float32)


def _router_stats(probs, load, K: int):
    """(me, ce) of a load-balance loss: each expert's mean router
    probability ``probs`` (n, E) and share of the n·K choices ``load`` (E,)
    over this rank's rows, or, where they are its block of the microbatch's
    rows (:func:`row_group`), over all of them: the sums over the group,
    the probabilities' through _Reduce (every rank has the whole loss)."""
    rows = row_group()
    n = probs.shape[0]
    if rows is None:
        return probs.mean(dim=0), load / (n * K)
    n *= dist.get_world_size(rows)
    return _Reduce.apply(probs.sum(dim=0), rows) / n, _all_reduce(load, rows) / (n * K)


def _all_to_all(x, group, sent=None, got=None):
    out = torch.empty_like(x) if got is None else x.new_empty((sum(got),) + x.shape[1:])
    dist.all_to_all_single(out, x.contiguous(), got, sent, group=group)
    record_collective("all-to-all", out)
    return out


class _Exchange(torch.autograd.Function):
    """:func:`_all_to_all` whose gradient is the reverse exchange (what
    ``torch.distributed.nn.functional.all_to_all_single`` computes), so
    that the backward pass's exchange is recorded too."""

    @staticmethod
    def forward(ctx, x, group, sent, got):
        ctx.group, ctx.sent, ctx.got = group, sent, got
        return _all_to_all(x, group, sent, got)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.got, ctx.sent), None, None, None


def _exchange(x, group, sent=None, got=None):
    """``all_to_all_single`` over ``group``: dim 0 of ``x`` in as many equal
    blocks as ranks (or of ``sent[j]`` rows), block j to rank j, block i of
    the result from rank i (of ``got[i]`` rows); its gradient is the reverse
    exchange."""
    return _Exchange.apply(x, group, sent, got)


def _overlap(ranges, lo: int, hi: int):
    """The parts of the sorted, disjoint column ``ranges`` inside [lo, hi)."""
    return [(max(a, lo), min(b, hi)) for a, b in ranges if max(a, lo) < min(b, hi)]


def _fetch_columns(y, wants, group, what: str):
    """Columns of a packed last axis that the ranks of ``group`` hold in
    contiguous equal blocks, rank j the j-th (the serve rules' cut; ``y`` is
    this rank's block): ``wants[j]`` lists the sorted, disjoint (start,
    stop) column ranges that rank j needs, and this rank gets its own, in
    order, (..., their widths summed), dense.  One all-to-all moves every
    rank's pieces; what this rank receives from the others is counted in
    ``GATHERED[what]``.  The gradient is the reverse exchange."""
    m, tp = _rank_and_size(group)
    c = y.shape[-1]
    cols = y.movedim(-1, 0)                         # the exchange splits dimension 0
    send = [(j, a, b) for j in range(tp) for a, b in _overlap(wants[j], m * c, (m + 1) * c)]
    sent = [sum(b - a for k, a, b in send if k == j) for j in range(tp)]
    got = [sum(b - a for a, b in _overlap(wants[m], i * c, (i + 1) * c)) for i in range(tp)]
    pieces = torch.cat([cols[a - m * c:b - m * c] for _, a, b in send]) if send else cols[:0]
    GATHERED[what] += (sum(got) - got[m]) * (y.numel() // c) * y.element_size()
    # dense again in the packed axis, as K3 takes its operands
    return _exchange(pieces, group, sent, got).movedim(0, -1).contiguous()


def _local_experts(cfg: ModelConfig, p, rows, local_id, E_loc: int, force):
    """The received rows through this rank's experts: rows (m, d), their
    local expert ids (m,), -1 for an empty slot -> (m, d), zero where
    empty.  The rows are sorted by expert for two grouped products, so each
    row is multiplied by its own expert alone."""
    valid = local_id >= 0
    key = torch.where(valid, local_id, E_loc).long()
    order = torch.argsort(key, stable=True)
    sizes = torch.zeros(E_loc + 1, dtype=torch.int32, device=rows.device).index_add_(
        0, key, torch.ones_like(key, dtype=torch.int32))[:E_loc]
    h = grouped_mm(rows[order], p["w_in"], sizes, force=force)
    if cfg.mlp_act == "swiglu":
        hi, hg = torch.chunk(h, 2, dim=-1)
        h = F.silu(hi) * hg
    else:
        h = F.gelu(h, approximate="tanh")
    ys = grouped_mm(h, p["w_out"], sizes, force=force)
    # the empty rows sort last and were not computed
    ys = torch.where(valid[order][:, None], ys, torch.zeros((), dtype=ys.dtype, device=ys.device))
    return torch.zeros_like(rows).index_copy(0, order, ys)


def moe_a2a(cfg: ModelConfig, p, x, *, force: Optional[str] = None):
    """Expert-parallel MoE with explicit dispatch and combine all-to-alls
    over the ambient mesh's "model" ranks, as the reference's ``moe_a2a``.

    ``p`` is this rank's tree (:func:`repro_torch.launch.mesh.shard_params`):
    the router whole, ``w_in``/``w_out`` its E / ep experts.  x (B, T, d) is
    the same on every rank of the "model" group (its data rank's batch
    block, or the whole batch where the batch axes do not divide it).  Rank
    m takes the sequence block [m·T/ep, (m+1)·T/ep), the reference's
    ``x_spec = P(b_spec, "model", None)``, and

    * routes it locally (fp32 logits, softmax, top-k, gates renormalised);
    * buckets each (token, choice) pair by the rank of its expert, in the
      cumulative order of the flattened pairs, ``cap = ceil(n_loc·K / ep ·
      capacity_factor)`` slots a destination, the rest dropped;
    * exchanges the rows and their local expert ids (-1 marks an empty
      slot) with an all-to-all, runs its experts' two grouped products on
      the received rows sorted by expert, and sends the results back with
      a second one;
    * sums each token's results weighted by gate × keep (:func:`_combine`).

    The blocks are then all-gathered over "model", so every rank holds the
    whole (B, T, d) output again: the port's counterpart of the resharding
    GSPMD does after the reference's ``out_specs``.

    Which pairs drop is the reference's: the pairs past ``cap`` and, where a
    destination overflows, also the pair in its last slot
    (:func:`_overwritten_by_a_drop`, ROADMAP fault F6).

    Falls back to :func:`moe` where the reference does: no ambient mesh, no
    "model" axis, one "model" rank, or E % ep (the experts then stay whole).
    Where T % ep (a decode step) it runs the dropless MoE on the sharded
    experts: every rank routes every token, runs the pairs bound for its
    own experts, and the partial outputs are summed over "model".

    A serving rank that holds its block of the experts' d gathers them
    over the batch axes first (:func:`gather_experts`).

    Returns (y (B, T, d), aux).  Every rank returns the same statistics:
    the means over the "model" ranks of each rank's router probabilities and
    expert loads, which are the dropless MoE's over the same tokens (the
    reference returns one shard's, the first device's); the main path also
    gives ``dropped``, the pairs dropped on all the group's ranks."""
    mesh = ambient_mesh()
    p = gather_experts(cfg, p, x)
    moe_cfg = cfg.moe
    E, K = moe_cfg.num_experts, moe_cfg.top_k
    B, T, d = x.shape
    m, ep = model_coordinate(mesh)
    if ep == 1 or E % ep:
        return moe(cfg, p, x, force=force)
    group = mesh.get_group("model")
    p = {**p, "router": _Copy.apply(p["router"], group)}    # its gradient summed over "model"
    E_loc = E // ep
    if p["w_in"].shape[0] != E_loc:
        raise ValueError(f"moe_a2a needs this rank's {E_loc} of {E} experts "
                         f"(launch.mesh.shard_params), got {p['w_in'].shape[0]}")
    if T % ep:
        return _moe_expert_sharded(cfg, p, x, group, m, ep, force)
    T_loc = T // ep
    n_loc = B * T_loc
    cap = max(1, int(math.ceil(n_loc * K / ep * moe_cfg.capacity_factor)))

    xf = _Split.apply(x, 1, group).reshape(n_loc, d)
    probs, gate, idx = moe_route(cfg, p, xf)
    flat_e = idx.reshape(-1)                                          # (n_loc*K,)
    tok_of = torch.arange(n_loc * K, device=x.device) // K
    dest = flat_e // E_loc
    onehot = F.one_hot(dest, ep)
    slot = (torch.cumsum(onehot, 0) - 1).gather(1, dest[:, None])[:, 0]
    keep = (slot < cap) & ~_overwritten_by_a_drop(slot, onehot.sum(0) > cap, dest, cap)
    at = dest * cap + slot.clamp(max=cap - 1)
    # dropped pairs go to one spare row past the buffer, which is cut off
    to = torch.where(keep, at, ep * cap)
    send_x = xf.new_zeros((ep * cap + 1, d)).index_copy(0, to, xf[tok_of])[:-1]
    send_e = torch.full((ep * cap + 1,), -1, dtype=torch.int32, device=x.device).index_copy(
        0, to, (flat_e % E_loc).int())[:-1]

    rows = _exchange(send_x, group)
    local_id = _exchange(send_e, group)
    back = _exchange(_local_experts(cfg, p, rows, local_id, E_loc, force), group)

    y = _combine(back[at], gate * keep.view(n_loc, K))
    y = _Gather.apply(y.reshape(B, T_loc, d), 1, group)

    load = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    stats = _Reduce.apply(torch.cat([probs.mean(dim=0) / ep, load / (n_loc * K * ep),
                                     (~keep).sum()[None].float()]), group)
    me, ce = stats[:E], stats[E:2 * E].detach()
    return y, {"moe_aux_loss": E * torch.sum(me * ce), "expert_load": ce,
               "dropped": stats[2 * E].detach().round().long()}


def _overwritten_by_a_drop(slot, overflow, dest, cap: int):
    """The kept pairs that the reference's ``moe_a2a`` also loses (ROADMAP
    fault F6): the pair in slot ``cap - 1`` of a destination that overflows.
    The reference clamps a dropped pair's slot to ``cap - 1`` and scatters
    its zeros there too; the order of those duplicate-index writes is left
    to the implementation by JAX, and XLA on the CPU applies them in order,
    so the dropped pair's zeros win and the slot goes out empty.  The port
    reproduces that order, so that its y and dropped pairs are the
    reference's as the tests run it; to keep the pair instead, return
    ``torch.zeros_like(slot, dtype=torch.bool)``."""
    return (slot == cap - 1) & overflow[dest]


def _moe_expert_sharded(cfg: ModelConfig, p, x, group, m: int, ep: int, force):
    """The dropless MoE on expert-sharded weights (:func:`moe_a2a` where T %
    ep): rank m routes every token, runs the (token, choice) pairs bound for
    its experts m·E/ep .. (m+1)·E/ep − 1, and the partial outputs are summed
    over "model" in fp32.  The statistics are every token's, as
    :func:`moe`'s (:func:`_router_stats`)."""
    moe_cfg = cfg.moe
    E, K = moe_cfg.num_experts, moe_cfg.top_k
    B, T, d = x.shape
    n = B * T
    E_loc = E // ep
    xf = _Copy.apply(x, group).reshape(n, d)
    probs, gate, idx = moe_route(cfg, p, xf)
    flat_e = idx.reshape(-1)
    local_id = torch.where(flat_e // E_loc == m, flat_e - m * E_loc, -1)
    token_of = torch.arange(n * K, device=x.device) // K
    ys = _local_experts(cfg, p, xf[token_of], local_id, E_loc, force)
    y = _reduce_partial(_combine(ys, gate), group)

    load = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    me, ce = _router_stats(probs, load, K)
    # every rank computes the same loss from the same routing: a 1/ep share a
    # rank sums to one loss's gradient over the ranks (_Copy, the router sum)
    aux = _Reduce.apply(E * torch.sum(me * ce) / ep, group)
    return y.reshape(B, T, d), {"moe_aux_loss": aux, "expert_load": ce}


# --------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin)
# --------------------------------------------------------------------------

RGLRU_CHUNK = 16    # positions of one block of the chunked scan (rglru_scan)


def rglru_params(cfg: ModelConfig, generator: torch.Generator, dtype, device=None, lead=()):
    """The reference's RG-LRU block: input and gate branches, the recurrence
    and input gates, the output projection, the depthwise conv and the fp32
    Λ, a linspace from −4.3 to −9.0 over the width."""
    rg = cfg.rglru
    w = rg.lru_width
    kw = dict(dtype=dtype, device=device, lead=lead)
    shape = tuple(lead) + (w,)
    lam = _fixed(lambda: torch.linspace(-4.3, -9.0, w, dtype=torch.float32,
                                        device=device).expand(shape).clone(), shape, device)
    return {
        "w_x": dense_init((cfg.d_model, w), generator, **kw),
        "w_gate_in": dense_init((cfg.d_model, w), generator, **kw),
        "w_a": dense_init((w, w), generator, **kw),
        "w_i": dense_init((w, w), generator, **kw),
        "w_out": dense_init((w, cfg.d_model), generator, **kw),
        "conv": dense_init((rg.conv_width, w), generator, **kw),
        "log_lambda": lam,
    }


def rglru_scan(log_a, b, h0, chunk: int = RGLRU_CHUNK):
    """h_t = exp(log_a_t)·h_{t−1} + b_t from h_{−1} = h0, every t at once.
    log_a, b: (B, T, W) fp32; h0: (B, W) fp32 -> h (B, T, W) fp32.

    In blocks of ``chunk`` positions: inside a block h is a sum of b_s
    weighted by exp(cum_t − cum_s), the block-local cumulative sums of
    log_a, which stay small (a single cumulative sum over T overflows
    exp(−·) in fp32 past about 800 positions at Λ = −4.3); across blocks
    each block's entering state is the same sum over the blocks before it,
    their decays summed in fp64.  Every exponent is a difference of later
    minus earlier sums, so it is at most 0 and nothing is divided.  A ragged
    last block is padded with a = 1, b = 0, which leaves the earlier
    positions as they are.  T = 1 is the one step."""
    B, T, W = b.shape
    if T == 1:
        return torch.exp(log_a) * h0[:, None, :] + b
    pad = (-T) % chunk
    if pad:
        log_a = F.pad(log_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    n = (T + pad) // chunk
    la = log_a.view(B, n, chunk, W)
    cum = torch.cumsum(la, dim=2)                                     # (B, n, C, W)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=b.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]              # (B, n, t, s, W)
    weights = torch.exp(diff.masked_fill(~causal[:, :, None], -math.inf))
    local = (weights * b.view(B, n, 1, chunk, W)).sum(dim=3)          # from a zero state
    # the state entering block c: the blocks before it, decayed to its start
    ends = torch.cumsum(cum[:, :, -1, :].double(), dim=1)             # (B, n, W) fp64
    blocks = torch.tril(torch.ones(n, n, dtype=torch.bool, device=b.device))
    decay = torch.exp((ends[:, :, None, :] - ends[:, None, :, :]).masked_fill(
        ~blocks[:, :, None], -math.inf)).float()                      # (B, c, c', W)
    after = (decay * local[:, None, :, -1, :]).sum(dim=2) \
        + torch.exp(ends).float() * h0[:, None, :]                    # state after block c
    entering = torch.cat([h0[:, None, :], after[:, :-1]], dim=1)
    h = local + torch.exp(cum) * entering[:, :, None, :]
    return h.reshape(B, n * chunk, W)[:, :T]


def rglru(cfg: ModelConfig, p, x, h0=None, conv_state=None):
    """RG-LRU block.  x: (B,T,d) -> (y (B,T,d), hT (B,W) fp32, conv_stateT).

    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ u_t) with
    a_t = exp(−8 · softplus(Λ) · r_t), the r and i gates from the conv'd
    input branch; the recurrence runs in fp32 (:func:`rglru_scan`).

    A rank that holds its block of the width W (the columns of ``w_x``,
    ``w_gate_in``, ``w_a`` and ``w_i``, the rows of ``w_out``) runs its W/tp
    channels, the recurrence being elementwise in W: its slice of the
    replicated ``conv`` and Λ, its states (h0 and the conv state: (B, W/tp)
    and (B, K−1, W/tp)), and the gates' products over the whole conv'd
    input, gathered over "model" once a call; its partial output is reduced
    in fp32."""
    B, T, _ = x.shape
    W_loc = p["w_x"].shape[-1]
    group = tp_group(W_loc, cfg.rglru.lru_width)
    conv, log_lambda = p["conv"], p["log_lambda"]
    if group is not None:
        x = _Copy.apply(x, group)
        conv = _own_block(_Copy.apply(conv, group), -1, W_loc, group)
        log_lambda = _own_block(_Copy.apply(log_lambda, group), -1, W_loc, group)
    u = x @ p["w_x"]                                       # (B,T,W)
    g = F.silu(x @ p["w_gate_in"])                         # gate branch
    u_conv, conv_state = _causal_conv1d(u, conv, conv_state)
    u_whole = u_conv
    if group is not None:
        GATHERED["rglru"] += u_conv.numel() * u_conv.element_size() * (dist.get_world_size(group) - 1)
        # the whole input feeds each rank's own gate columns: its gradient
        # is summed over "model" before each rank keeps its block
        u_whole = _Copy.apply(_Gather.apply(u_conv, u_conv.dim() - 1, group), group)
    r = torch.sigmoid(u_whole @ p["w_a"]).float()
    i = torch.sigmoid(u_whole @ p["w_i"]).float()
    log_a = -8.0 * F.softplus(log_lambda) * r              # (B,T,W) fp32
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * i * u_conv.float()
    if h0 is None:
        h0 = torch.zeros((B, u.shape[-1]), dtype=torch.float32, device=x.device)
    h = rglru_scan(log_a, b, h0)
    y = (h.to(x.dtype) * g) @ p["w_out"]
    return _reduce_partial(y, group), h[:, -1, :], conv_state


def rglru_step(cfg: ModelConfig, p, x_t, h_prev, conv_state):
    """Single decode step.  x_t: (B,1,d); h_prev: (B,W); conv: (B,K-1,W)."""
    return rglru(cfg, p, x_t, h0=h_prev, conv_state=conv_state)


# --------------------------------------------------------------------------
# Mamba2 / SSD (state-space duality)
# --------------------------------------------------------------------------


def _causal_conv1d(x, weights, state=None):
    """Depthwise causal conv.  x: (B,T,W); weights: (K,W); state: (B,K-1,W)."""
    K = weights.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, T+K-1, W)
    T = x.shape[1]
    out = sum(xp[:, i:i + T, :] * weights[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return out, new_state


def ssd_params(cfg: ModelConfig, generator: torch.Generator, dtype, device=None, lead=()):
    ssm = cfg.ssm
    d_in = ssm.d_inner(cfg.d_model)
    nheads = ssm.num_heads(cfg.d_model)
    kw = dict(dtype=dtype, device=device, lead=lead)
    heads = tuple(lead) + (nheads,)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj emits [z (gate), x, B, C, dt]
        "w_in": dense_init((cfg.d_model, 2 * d_in + 2 * ssm.state_dim + nheads), generator,
                           **kw),
        "conv": dense_init((ssm.conv_width, d_in + 2 * ssm.state_dim), generator, **kw),
        "A_log": _fixed(lambda: torch.log(torch.linspace(1.0, 16.0, nheads, **f32))
                        .expand(heads).clone(), heads, device),
        "D": torch.ones(heads, **f32),
        "dt_bias": torch.zeros(heads, **f32),
        "w_out": dense_init((d_in, cfg.d_model), generator, **kw),
        "norm_scale": torch.ones(tuple(lead) + (d_in,), dtype=dtype, device=device),
    }


def _ssd_split(cfg: ModelConfig, p, x):
    ssm = cfg.ssm
    d_in = ssm.d_inner(cfg.d_model)
    nheads = ssm.num_heads(cfg.d_model)
    zxbcdt = x @ p["w_in"]
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * ssm.state_dim, nheads], dim=-1)
    return z, xbc, dt, d_in, nheads


def _ssd_in(cfg: ModelConfig, p, x, conv_state):
    """The SSD block up to the scan: the projection, the depthwise conv and
    its SiLU.  Returns (z (B,T,H·P), xh (B,T,H,P), Bmat, Cmat (B,T,N), dt
    (B,T,H) raw, the new conv state, the per-head leaves {A_log, D,
    dt_bias, norm_scale}, the "model" group or None).

    A rank that holds its block of ``w_in``'s packed [z | x | B | C | dt]
    columns (the serve rules' contiguous cut) runs H/tp heads, heads
    m·H/tp .. of rank m, the rows of its block of ``w_out``: one exchange
    (:func:`_fetch_columns`) brings it z and dt of those heads and its
    block of the conv's d_inner + 2N channels, the block its conv state
    holds (the cache rules' cut), which it convolves with its block of the
    replicated conv weight; a second brings it x of its heads, and B and C
    whole, from the ranks whose blocks convolved them.  Both count in
    ``GATHERED["ssd"]``."""
    ssm = cfg.ssm
    d_in, N, P = ssm.d_inner(cfg.d_model), ssm.state_dim, ssm.head_dim
    H = ssm.num_heads(cfg.d_model)
    C = d_in + 2 * N                                      # conv channels: x, B, C
    group = tp_group(p["w_in"].shape[-1], d_in + C + H)
    conv = p["conv"]
    heads = {k: p[k] for k in ("A_log", "D", "dt_bias", "norm_scale")}
    if group is None:
        z, xbc, dt = _ssd_split(cfg, p, x)[:3]
    else:
        tp = dist.get_world_size(group)
        Hl, Cl = H // tp, C // tp
        x = _Copy.apply(x, group)
        z, xbc, dt = torch.split(_fetch_columns(
            x @ p["w_in"], [[(j * Hl * P, (j + 1) * Hl * P), (d_in + j * Cl, d_in + (j + 1) * Cl),
                             (d_in + C + j * Hl, d_in + C + (j + 1) * Hl)] for j in range(tp)],
            group, "ssd"), [Hl * P, Cl, Hl], dim=-1)
        conv = _own_block(_Copy.apply(conv, group), -1, Cl, group)
        heads = {k: _own_block(_Copy.apply(v, group), -1, v.shape[-1] // tp, group)
                 for k, v in heads.items()}
    xbc, conv_state = _causal_conv1d(xbc, conv, conv_state)
    xbc = F.silu(xbc)
    if group is not None:
        xbc = _fetch_columns(xbc, [[(j * Hl * P, (j + 1) * Hl * P), (d_in, C)]
                                   for j in range(tp)], group, "ssd")
    xs, Bmat, Cmat = torch.split(xbc, [xbc.shape[-1] - 2 * N, N, N], dim=-1)
    xh = xs.unflatten(-1, (xs.shape[-1] // P, P))
    return z, xh, Bmat, Cmat, dt, conv_state, heads, group


def _ssd_out(y, z, heads, group, dtype):
    """The SSD block between the scan and ``w_out``: y (B,T,H,P) fp32, the
    skip D·x added, cast to ``dtype``, gated by SiLU(z) and normalised over
    d_inner (fp32 RMSNorm with ``norm_scale``).  On a rank, whose y holds
    its heads' channels, the squares are summed over its channels and that
    sum over "model" (fp32) before the norm."""
    y = y.flatten(-2).to(dtype) * F.silu(z)
    if group is None:
        return rms_norm(y, heads["norm_scale"])
    y32 = at_least_f32(y)
    # the sum feeds each rank's own channels: its gradient is summed too
    ss = _Copy.apply(_Reduce.apply(torch.sum(y32 * y32, dim=-1, keepdim=True), group), group)
    mean = ss / (y.shape[-1] * dist.get_world_size(group))
    return (y32 * torch.rsqrt(mean + 1e-6) * at_least_f32(heads["norm_scale"])).to(dtype)


def ssd_prefill(cfg: ModelConfig, p, x, state=None, conv_state=None, *,
                force: Optional[str] = None):
    """Mamba2 block over a sequence (chunked SSD).  x: (B,T,d), any T >= 1.

    Returns (y, final_state (B,H,N,P) fp32, conv_state (B,K-1,d_conv)).  The
    scan goes through ``ops.ssd_scan`` with ``state`` as its initial state;
    B and C are handed over as fp32 views of the projection (no copy in fp32).
    On a "model" rank (:func:`_ssd_in`) the scan runs over its heads from its
    block of the state, and the states are its blocks.
    """
    z, xh, Bmat, Cmat, dt, conv_state, hp, group = _ssd_in(cfg, p, x, conv_state)
    dt = F.softplus(at_least_f32(dt) + hp["dt_bias"])                 # (B,T,H)
    A = -torch.exp(hp["A_log"])                                       # (H,)
    xh = at_least_f32(xh)
    y, state = ops.ssd_scan(xh * dt[..., None], dt * A, at_least_f32(Bmat),
                            at_least_f32(Cmat), chunk=cfg.ssm.chunk_size, initial_state=state,
                            force=force)
    y = y + xh * hp["D"][None, None, :, None]
    y = _ssd_out(y, z, hp, group, x.dtype)
    return _reduce_partial(y @ p["w_out"], group), state, conv_state


def ssd_chunked_ref(xh, dt, A, Bmat, Cmat, *, chunk: int, initial_state=None):
    """Chunked SSD reference.  xh:(B,T,H,P) dt:(B,T,H) A:(H,) B/C:(B,T,N).

    h_t = a_t h_{t-1} + dt_t B_t x_t, y_t = C_t·h_t, with a_t = exp(dt_t A).
    Unlike the reference it takes any T: a ragged last chunk is padded with
    zeros, which is exact (see ``kernels.ref.ssd_scan_chunked``)."""
    return ref.ssd_scan_chunked(xh.float() * dt[..., None], dt * A, Bmat, Cmat, chunk=chunk,
                                initial_state=initial_state)


def ssd_decode_step(cfg: ModelConfig, p, x_t, state, conv_state):
    """Single-token SSD update.  x_t: (B,1,d); state: (B,H,N,P): a rank's
    heads on a "model" rank, as :func:`ssd_prefill`."""
    z, xh, Bmat, Cmat, dt, conv_state, hp, group = _ssd_in(cfg, p, x_t, conv_state)
    xh = xh[:, 0].float()                                              # (B,H,P)
    dt1 = F.softplus(dt[:, 0].float() + hp["dt_bias"])                 # (B,H)
    A = -torch.exp(hp["A_log"])
    a = torch.exp(dt1 * A[None, :])                                    # (B,H)
    Bv = Bmat[:, 0].float()                                            # (B,N)
    Cv = Cmat[:, 0].float()
    dx = xh * dt1[..., None]                                           # (B,H,P)
    state = state * a[:, :, None, None] + torch.einsum("bn,bhp->bhnp", Bv, dx)
    y = torch.einsum("bn,bhnp->bhp", Cv, state)
    y = y + xh * hp["D"][None, :, None]
    y = _ssd_out(y[:, None], z, hp, group, x_t.dtype)
    return _reduce_partial(y @ p["w_out"], group), state, conv_state
