"""Plain-torch versions of the kernels.

Twins of ``repro.kernels.ref``: the same masking, the same ``-1e30`` fill and
an fp32 softmax for attention; the exact sequential SSD recurrence
(:func:`ssd_scan_ref`), and beside it the chunked SSD algorithm with K3's
signature (:func:`ssd_scan_chunked`).  The CPU path of
:mod:`repro_torch.kernels.ops` runs ``flash_attention_ref``,
``paged_attention_ref`` and ``ssd_scan_chunked``; on the card they run only
when a caller asks for them (``force="plain"``), to hold the CUDA kernels
against them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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
