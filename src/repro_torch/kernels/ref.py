"""Plain-torch versions of the attention kernels.

Twins of ``repro.kernels.ref``: the same masking, the same ``-1e30`` fill and
an fp32 softmax.  The CPU path of :mod:`repro_torch.kernels.ops` runs these;
on the card they run only when a caller asks for them (``force="plain"``),
to hold the CUDA kernels against them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

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
