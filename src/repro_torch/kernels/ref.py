"""Plain-torch versions of the kernels.

Twins of ``repro.kernels.ref``: the same masking, the same ``-1e30`` fill and
an fp32 softmax for attention; the exact sequential SSD recurrence
(:func:`ssd_scan_ref`), and beside it the chunked SSD algorithm with K3's
signature (:func:`ssd_scan_chunked`).  The CPU path of
:mod:`repro_torch.kernels.ops` runs ``flash_attention_ref``,
``paged_attention_ref`` and ``ssd_scan_chunked``; on the card they run only
when a caller asks for them (``force="plain"``), to hold the CUDA kernels
against them.  ``flash_attention_tiled``, ``paged_attention_split`` and
``ssd_scan_two_pass`` spell out the CUDA kernels' own decompositions (K1's
packed tiles and edge-masked KV walk, K2's split and merge, K3's two passes)
in plain PyTorch for the tests and ``chip_smoke.py``; no model path calls
them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import flash_attention as flash_mod
from .paged_attention import PARTITION

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softmax_scale: Optional[float] = None):
    """q: (B,T,Hq,D); k,v: (B,S,Hkv,D) -> (B,T,Hq,D).  fp32 softmax."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale or 1.0 / math.sqrt(D)
    qg = q.reshape(B, T, Hkv, G, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k).float() * scale
    q_pos = torch.arange(T, device=q.device)[:, None]
    kv_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        # queries are the *last* T positions of the S-long stream
        offset = S - T
        mask &= kv_pos <= q_pos + offset
        if window is not None:
            mask &= (q_pos + offset) - kv_pos < window
    scores = torch.where(mask[None, None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype), v)
    return out.reshape(B, T, Hq, D)


def flash_attention_tiled(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                          softmax_scale: Optional[float] = None, block_rows: int = 128,
                          block_keys: int = 64):
    """K1's bf16 kernel in plain PyTorch, tile by tile (shapes as
    :func:`flash_attention_ref`; returns q's type).

    The tiles are ``flash_attention.plan``'s: each holds ``block_rows`` rows,
    the ``pack`` query heads of one KV head at consecutive positions in
    (position, head) order.  Each tile walks the KV tiles it can see
    (``kv_tile_range``), K and V padded with zero rows past S as TMA fills
    them; only a tile for which ``tile_needs_mask`` holds is masked.  The
    online softmax runs in the log2 domain in fp32 (scores from fp32
    products), P is rounded to the input type before P @ V and the row sums
    take P before rounding; a row that sees no key gives 0."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    p = flash_mod.plan(B, T, S, Hq, Hkv, D, block_rows=block_rows, block_keys=block_keys)
    scale_log2 = (softmax_scale or 1.0 / math.sqrt(D)) * math.log2(math.e)
    offset = S - T
    bk = block_keys
    pad = (-S) % bk
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)   # (B, Hkv, S + pad, D)
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    qf = q.float().reshape(B, T, Hkv, p.groups, p.pack, D)
    out = torch.zeros((B, T, Hkv, p.groups, p.pack, D), dtype=torch.float32, device=q.device)
    for qt in range(p.q_tiles):
        q0 = qt * p.positions
        n = min(p.positions, T - q0)          # rows past T are zeros the kernel never stores
        rows = qf[:, q0:q0 + n].permute(0, 2, 3, 1, 4, 5).reshape(B, Hkv, p.groups, n * p.pack, D)
        qpos = q0 + torch.arange(n * p.pack, device=q.device) // p.pack + offset
        q_lo, q_hi = q0 + offset, q0 + n - 1 + offset
        m = torch.full(rows.shape[:-1], -math.inf, device=q.device)
        l = torch.zeros(rows.shape[:-1], device=q.device)
        acc = torch.zeros(rows.shape, device=q.device)
        first, end = flash_mod.kv_tile_range(q0, p.positions, T, S, bk, causal, window)
        for kt in range(first, end):
            k0 = kt * bk
            s = torch.einsum("bhgrd,bhkd->bhgrk", rows, kf[:, :, k0:k0 + bk]) * scale_log2
            if flash_mod.tile_needs_mask(k0, bk, S, q_lo, q_hi, causal, window):
                key = k0 + torch.arange(bk, device=q.device)
                ok = (key < S)[None, :].expand(len(qpos), bk)
                if causal:
                    ok = ok & (key[None, :] <= qpos[:, None])
                    if window is not None:
                        ok = ok & (qpos[:, None] - key[None, :] < window)
                s = torch.where(ok, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_use = torch.where(torch.isinf(m_new), 0.0, m_new)
            alpha = torch.exp2(m - m_use)
            pt = torch.exp2(s - m_use[..., None])
            l = l * alpha + pt.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgrk,bhkd->bhgrd", pt.to(q.dtype).float(), vf[:, :, k0:k0 + bk])
            m = m_new
        o = torch.where(l[..., None] > 0, acc / torch.where(l > 0, l, 1.0)[..., None], 0.0)
        out[:, q0:q0 + n] = o.reshape(B, Hkv, p.groups, n, p.pack, D).permute(0, 3, 1, 2, 4, 5)
    return out.reshape(B, T, Hq, D).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens, *,
                        softmax_scale: Optional[float] = None):
    """Decode attention against a paged KV pool.

    q:            (B, Hq, D)      — one query token per sequence
    k/v_pages:    (num_pages, page_size, Hkv, D)
    block_tables: (B, pages_per_seq) int32 — page ids per sequence
    context_lens: (B,) int32      — valid KV length per sequence
    returns       (B, Hq, D)
    """
    B, Hq, D = q.shape
    P, page_size, Hkv, _ = k_pages.shape
    pages_per_seq = block_tables.shape[1]
    G = Hq // Hkv
    scale = softmax_scale or 1.0 / math.sqrt(D)

    tables = block_tables.long()
    k = k_pages[tables]  # (B, pages, page_size, Hkv, D)
    v = v_pages[tables]
    S = pages_per_seq * page_size
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)
    qg = q.reshape(B, Hkv, G, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k).float() * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < context_lens.to(q.device)[:, None])
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs.to(v.dtype), v)
    return out.reshape(B, Hq, D)


def paged_attention_split(q, k_pages, v_pages, block_tables, context_lens, *,
                          partition: int = PARTITION, softmax_scale: Optional[float] = None):
    """K2's algorithm in plain PyTorch: split each context into partitions of
    ``partition`` keys (a multiple of the page size; their number comes from
    ``pages_per_seq``, not from the lengths), take each partition's softmax
    statistics (m, l) and unnormalised sum acc = Σ exp(s − m)·v in fp32, then
    merge them exactly: o = Σ exp(m_i − M)·acc_i / Σ exp(m_i − M)·l_i over the
    non-empty partitions.  An empty context gives 0 (as the Pallas kernel
    does; ``paged_attention_ref`` gives the mean of V there).  Shapes as
    :func:`paged_attention_ref`; returns (B, Hq, D) in q's type."""
    m, l, acc = paged_attention_partials(q, k_pages, v_pages, block_tables, context_lens,
                                         partition=partition, softmax_scale=softmax_scale)
    return paged_attention_merge(m, l, acc).to(q.dtype)


def paged_attention_partials(q, k_pages, v_pages, block_tables, context_lens, *,
                             partition: int = PARTITION, softmax_scale: Optional[float] = None):
    """The first pass of :func:`paged_attention_split`: fp32 partials m, l of
    shape (B, Hq, NP) and acc of shape (B, Hq, NP, D); an empty partition has
    m = −inf, l = 0 and acc = 0."""
    B, Hq, D = q.shape
    _, page_size, Hkv, _ = k_pages.shape
    pps = block_tables.shape[1]
    if partition <= 0 or partition % page_size:
        raise ValueError(f"partition {partition} is not a multiple of the page size "
                         f"{page_size}")
    G = Hq // Hkv
    scale = softmax_scale or 1.0 / math.sqrt(D)
    NP = max(1, -(-pps * page_size // partition))
    S = NP * partition
    tables = F.pad(block_tables.long(), (0, S // page_size - pps))   # pad with page 0
    k = k_pages[tables].reshape(B, S, Hkv, D).float()
    v = v_pages[tables].reshape(B, S, Hkv, D).float()
    qg = q.reshape(B, Hkv, G, D).float() * scale
    s = torch.einsum("bhgd,bshd->bhgs", qg, k)
    ctx = torch.clamp(context_lens.to(q.device).long(), max=pps * page_size)
    valid = torch.arange(S, device=q.device)[None, :] < ctx[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.tensor(-torch.inf, device=q.device))
    s = s.reshape(B, Hkv, G, NP, partition)
    m = s.amax(dim=-1)                                                # (B,Hkv,G,NP)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])   # masked keys -> 0
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgnj,bnjhd->bhgnd", p, v.reshape(B, NP, partition, Hkv, D))
    return m.reshape(B, Hq, NP), l.reshape(B, Hq, NP), acc.reshape(B, Hq, NP, D)


def paged_attention_merge(m, l, acc):
    """The second pass of :func:`paged_attention_split`: (B, Hq, D) in fp32."""
    M = m.amax(dim=-1, keepdim=True)
    w = torch.where(torch.isinf(m), 0.0, torch.exp(m - torch.where(torch.isinf(M), 0.0, M)))
    num = (w[..., None] * acc).sum(dim=2)
    den = (w * l).sum(dim=2)[..., None]
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def ssd_scan_ref(xdt, dA, Bm, Cm, *, initial_state=None):
    """Sequential SSD recurrence oracle (exact, O(T)).

    xdt: (B,T,H,P) — dt-premultiplied inputs; dA: (B,T,H) — log decay
    Bm/Cm: (B,T,N); returns (y (B,T,H,P), final_state (B,H,N,P)) in fp32.
    """
    B, T, H, P = xdt.shape
    N = Bm.shape[-1]
    xdt, dA, Bm, Cm = xdt.float(), dA.float(), Bm.float(), Cm.float()
    s = (torch.zeros((B, H, N, P), dtype=torch.float32, device=xdt.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(T):
        s = (s * torch.exp(dA[:, t])[:, :, None, None]
             + torch.einsum("bn,bhp->bhnp", Bm[:, t], xdt[:, t]))
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], s))
    return torch.stack(ys, dim=1), s


def ssd_scan_chunked(xdt, dA, Bm, Cm, *, chunk: int = 128, initial_state=None):
    """The chunked SSD algorithm of ``repro.models.layers.ssd_chunked_ref`` with
    K3's signature: the CUDA kernel's plain version.

    xdt: (B,T,H,P); dA: (B,T,H); Bm/Cm: (B,T,N); initial_state: (B,H,N,P) or
    None.  Chunks are ``min(chunk, T)`` long; a ragged tail is padded with
    zeros (a padded position has dA = 0 and xdt = 0: it multiplies the state
    by exp(0) = 1 and adds nothing, so the padding is exact).  Returns
    (y (B,T,H,P), final_state (B,H,N,P)) in fp32.
    """
    B, T, H, P = xdt.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    pad = (-T) % Q
    x, a, Bf, Cf = xdt.float(), dA.float(), Bm.float(), Cm.float()
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a, Bf, Cf = (F.pad(t, (0, 0, 0, pad)) for t in (a, Bf, Cf))
    nC = (T + pad) // Q
    x = x.reshape(B, nC, Q, H, P)
    a = a.reshape(B, nC, Q, H)
    Bc = Bf.reshape(B, nC, Q, N)
    Cc = Cf.reshape(B, nC, Q, N)

    # The inclusive cumsum is taken in fp64 and differenced before it is
    # rounded to fp32: in fp32 a cumsum that reaches -90 over a chunk carries
    # absolute errors of ~1e-5, which every decay exp(cum_i - cum_j) turns
    # into a relative error, enough to move y by 2e-4 at N = 128.
    cum = torch.cumsum(a.double(), dim=2)                  # (B,C,Q,H) inclusive
    # L[i,j] = exp(cum_i - cum_j) for i >= j; the mask goes on the exponent,
    # since upper-triangle deltas are positive and exp would overflow
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    delta = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).float()  # (B,C,i,j,H)
    delta = torch.where(mask[None, None, :, :, None], delta,
                        torch.tensor(-torch.inf, device=x.device))
    L = torch.exp(delta)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", scores, L, x)

    decay_to_end = torch.exp((cum[:, :, -1:, :] - cum).float())      # (B,C,Q,H)
    s_local = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, decay_to_end, x)
    chunk_decay = torch.exp(cum[:, :, -1, :].float())                # (B,C,H)
    s = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    s_prev = []
    for c in range(nC):
        s_prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + s_local[:, c]
    s_prev = torch.stack(s_prev, dim=1)                    # (B,C,H,N,P)
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", Cc, torch.exp(cum.float()), s_prev)
    y = (y_intra + y_inter).reshape(B, nC * Q, H, P)[:, :T]
    return y, s


def ssd_chunk_pass(xdt, dA, Bm, Cm, *, chunk: int = 128):
    """The first pass of K3 in plain PyTorch, parallel over chunks: the T
    positions are cut into chunks of ``chunk`` (a ragged tail padded with
    zeros, which is exact).  Returns

    * ``CBt`` (B, C, Q, Q): C·Bᵀ of each chunk, transposed (row j, column i),
      computed once per chunk since it depends on neither head nor column;
    * ``cum`` (B, C, Q, H): the inclusive fp64 cumsum of dA in each chunk;
    * ``dS`` (B, C, H, N, P): each chunk's own state contribution
      Bᵀ·(exp(cum_last − cum) ∘ xdt);
    * ``decay`` (B, C, H): exp(cum_last), each chunk's decay of the state.
    """
    B, T, H, P = xdt.shape
    N = Bm.shape[-1]
    Q = chunk
    pad = (-T) % Q
    x, a, Bf, Cf = xdt.float(), dA.float(), Bm.float(), Cm.float()
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a, Bf, Cf = (F.pad(t, (0, 0, 0, pad)) for t in (a, Bf, Cf))
    nC = (T + pad) // Q
    x = x.reshape(B, nC, Q, H, P)
    Bc = Bf.reshape(B, nC, Q, N)
    Cc = Cf.reshape(B, nC, Q, N)
    cum = torch.cumsum(a.reshape(B, nC, Q, H).double(), dim=2)
    CBt = torch.einsum("bcjn,bcin->bcji", Bc, Cc)
    w = torch.exp((cum[:, :, -1:, :] - cum).float())                 # (B,C,Q,H)
    dS = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, w, x)
    decay = torch.exp(cum[:, :, -1, :].float())
    return CBt, cum, dS, decay


def ssd_scan_pass(xdt, Cm, CBt, cum, dS, decay, *, initial_state=None):
    """The second pass of K3 in plain PyTorch: each chunk starts from the
    state the chunk before it ended with, S ← decay·S + ΔS (the kernel takes
    it from the nearest earlier chunk that has published its end state and
    adds the ΔS of those in between), and
    y = (C·Bᵀ ∘ L)·xdt + exp(cum)·C·S_prev.  Takes the outputs of
    :func:`ssd_chunk_pass`; returns (y (B,T,H,P), final state (B,H,N,P))."""
    B, T, H, P = xdt.shape
    N = Cm.shape[-1]
    nC, Q = CBt.shape[1], CBt.shape[2]
    pad = nC * Q - T
    x = F.pad(xdt.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nC, Q, H, P)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(B, nC, Q, N)
    s = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nC):
        delta = (cum[:, c, :, None, :] - cum[:, c, None, :, :]).float()   # (B,i,j,H)
        L = torch.exp(torch.where(mask[None, :, :, None], delta,
                                  torch.tensor(-torch.inf, device=x.device)))
        y = torch.einsum("bji,bijh,bjhp->bihp", CBt[:, c], L, x[:, c])
        y = y + torch.einsum("bin,bih,bhnp->bihp", Cc[:, c], torch.exp(cum[:, c].float()), s)
        ys.append(y)
        s = s * decay[:, c, :, None, None] + dS[:, c]
    return torch.cat(ys, dim=1)[:, :T], s


def ssd_scan_two_pass(xdt, dA, Bm, Cm, *, chunk: int = 128, initial_state=None):
    """K3's two passes in plain PyTorch (:func:`ssd_chunk_pass`, then
    :func:`ssd_scan_pass`), with :func:`ssd_scan_chunked`'s signature and
    result.  Chunks are ``chunk`` long whatever T."""
    CBt, cum, dS, decay = ssd_chunk_pass(xdt, dA, Bm, Cm, chunk=chunk)
    return ssd_scan_pass(xdt, Cm, CBt, cum, dS, decay, initial_state=initial_state)
