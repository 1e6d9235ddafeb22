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
in plain PyTorch for the tests and ``chip_smoke.py``,
``flash_attention_tiled_f32`` and ``flash_attention_bwd_tiled`` the tiles of
K1's fp32 kernel and of its gradient kernel, with ``matmul_3xtf32`` (and
``tf32_round``) for the fp32 kernels' tensor-core arithmetic; no model path
calls them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import flash_attention as flash_mod
from . import flash_attention_bwd as bwd_mod
from .paged_attention import PARTITION

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softmax_scale: Optional[float] = None,
                        q_offset: Optional[int] = None, return_lse: bool = False):
    """q: (B,T,Hq,D); k,v: (B,S,Hkv,D) -> (B,T,Hq,D).  fp32 softmax.

    Query t sits at key position ``q_offset + t``; by default the queries
    are the last T of the S keys (``q_offset = S - T``).  A row that sees
    no key (a window that ends before the keys do) gives 0.  With
    ``return_lse`` it also returns the fp32 log-sum-exp of each row's
    scaled scores (B, T, Hq), -inf for a row that sees no key."""
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
        offset = S - T if q_offset is None else q_offset
        mask &= kv_pos <= q_pos + offset
        if window is not None:
            mask &= (q_pos + offset) - kv_pos < window
    seen = mask.any(dim=-1)[:, None]                                   # (T, 1)
    masked = torch.where(mask[None, None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(masked, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype), v)
    out = torch.where(seen[None, :, :, None, None], out, 0).reshape(B, T, Hq, D)
    if not return_lse:
        return out
    lse = torch.logsumexp(torch.where(mask[None, None, None], scores, -torch.inf), dim=-1)
    return out, lse.permute(0, 3, 1, 2).reshape(B, T, Hq)


def flash_attention_tiled(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                          softmax_scale: Optional[float] = None, block_rows: int = 128,
                          block_keys: int = 64, q_offset: Optional[int] = None,
                          return_lse: bool = False):
    """K1's bf16 kernel in plain PyTorch, tile by tile (shapes as
    :func:`flash_attention_ref`; returns q's type).

    The tiles are ``flash_attention.plan``'s: each holds ``block_rows`` rows,
    the ``pack`` query heads of one KV head at consecutive positions in
    (position, head) order.  Each tile walks the KV tiles it can see
    (``kv_tile_range``), K and V padded with zero rows past S as TMA fills
    them; only a tile for which ``tile_needs_mask`` holds is masked.  The
    online softmax runs in the log2 domain in fp32 (scores from fp32
    products), P is rounded to the input type before P @ V and the row sums
    take P before rounding; a row that sees no key gives 0.  ``q_offset``
    and ``return_lse`` as :func:`flash_attention_ref`'s; the lse is
    (m + log2 l) / log2 e of the log2-domain statistics, unpacked from the
    tile rows to (B, T, Hq)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    p = flash_mod.plan(B, T, S, Hq, Hkv, D, block_rows=block_rows, block_keys=block_keys)
    scale_log2 = (softmax_scale or 1.0 / math.sqrt(D)) * math.log2(math.e)
    offset = S - T if q_offset is None else q_offset
    bk = block_keys
    pad = (-S) % bk
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)   # (B, Hkv, S + pad, D)
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    qf = q.float().reshape(B, T, Hkv, p.groups, p.pack, D)
    out = torch.zeros((B, T, Hkv, p.groups, p.pack, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, T, Hkv, p.groups, p.pack), -math.inf, device=q.device)
    for qt in range(p.q_tiles):
        q0 = qt * p.positions
        n = min(p.positions, T - q0)          # rows past T are zeros the kernel never stores
        rows = qf[:, q0:q0 + n].permute(0, 2, 3, 1, 4, 5).reshape(B, Hkv, p.groups, n * p.pack, D)
        qpos = q0 + torch.arange(n * p.pack, device=q.device) // p.pack + offset
        q_lo, q_hi = q0 + offset, q0 + n - 1 + offset
        m = torch.full(rows.shape[:-1], -math.inf, device=q.device)
        l = torch.zeros(rows.shape[:-1], device=q.device)
        acc = torch.zeros(rows.shape, device=q.device)
        first, end = flash_mod.kv_tile_range(q0, p.positions, T, S, bk, causal, window,
                                             offset)
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
        row_lse = torch.where(l > 0, (m + torch.log2(torch.where(l > 0, l, 1.0))) * math.log(2),
                              -math.inf)
        lse[:, q0:q0 + n] = row_lse.reshape(B, Hkv, p.groups, n, p.pack).permute(0, 3, 1, 2, 4)
    out = out.reshape(B, T, Hq, D).to(q.dtype)
    return (out, lse.reshape(B, T, Hq)) if return_lse else out


def tf32_round(x):
    """``x`` (fp32) rounded to TF32: to nearest, ties away from zero, at 10
    mantissa bits, as ``cvt.rna.tf32.f32`` rounds (finite inputs).  The
    result is an fp32 tensor whose low 13 mantissa bits are zero."""
    bits = x.float().contiguous().view(torch.int32)
    # sign and magnitude: adding half of the dropped bits' unit rounds the
    # magnitude away from zero at a tie, whatever the sign
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_tf32(a, b):
    """One TF32 pass: ``a @ b`` with both operands rounded to TF32 and the
    products summed in fp32 (a TF32 product is exact in fp32).  It keeps
    about three digits; K1's kernels do not use it."""
    return torch.matmul(tf32_round(a), tf32_round(b))


def matmul_3xtf32(a, b):
    """``a @ b`` (fp32) as K1's fp32 kernels compute it on the tensor cores
    (``csrc/mma.cuh``): each operand split into big = tf32(x) and small =
    tf32(x - big), and three TF32 products, the small terms first:
    small_a big_b + big_a small_b + big_a big_b (small_a small_b dropped)."""
    a, b = a.float(), b.float()
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = tf32_round(a - a_big), tf32_round(b - b_big)
    return (torch.matmul(a_small, b_big) + torch.matmul(a_big, b_small)
            + torch.matmul(a_big, b_big))


def _tile_mask(q0, n, k0, nk, S, offset, causal, window, device):
    """(n, nk) bool: query rows q0.. (at key position ``offset + t``) against
    keys k0..: the key lies before S and, under the causal mask, at or
    before the query and within the window."""
    qpos = offset + torch.arange(q0, q0 + n, device=device)[:, None]
    key = torch.arange(k0, k0 + nk, device=device)[None, :]
    ok = (key < S).expand(n, nk)
    if causal:
        ok = ok & (key <= qpos)
        if window is not None:
            ok = ok & (qpos - key < window)
    return ok


def flash_attention_tiled_f32(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                              softmax_scale: Optional[float] = None,
                              q_offset: Optional[int] = None, return_lse: bool = False,
                              matmul=None):
    """K1's fp32 kernel in plain PyTorch, tile by tile (shapes as
    :func:`flash_attention_ref`; returns fp32).

    The tiles are ``flash_attention.f32_plan``'s: 64 query rows of one head
    walk the KV tiles of ``F32_KEYS[D]`` keys they can see
    (``kv_tile_range``), K and V padded with zero rows past S as the
    ``cp.async`` ring fills them; only a tile for which ``tile_needs_mask``
    holds is masked.  The online softmax runs in the log2 domain in fp32.
    Both products go through ``matmul`` (the kernel's is
    :func:`matmul_3xtf32`; the default is ``torch.matmul``)."""
    mm = matmul or torch.matmul
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    p = flash_mod.f32_plan(B, T, S, Hq, Hkv, D)
    bk, rows = p.block_keys, p.block_rows
    scale_log2 = (softmax_scale or 1.0 / math.sqrt(D)) * math.log2(math.e)
    offset = S - T if q_offset is None else q_offset
    pad = (-S) % bk
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(G, dim=2).transpose(1, 2)
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(G, dim=2).transpose(1, 2)
    qf = q.float().transpose(1, 2)                                    # (B, Hq, T, D)
    out = torch.zeros((B, Hq, T, D), device=q.device)
    lse = torch.full((B, Hq, T), -math.inf, device=q.device)
    for qt in range(p.q_tiles):
        q0 = qt * rows
        n = min(rows, T - q0)
        m = torch.full((B, Hq, n), -math.inf, device=q.device)
        l = torch.zeros((B, Hq, n), device=q.device)
        acc = torch.zeros((B, Hq, n, D), device=q.device)
        q_lo, q_hi = q0 + offset, q0 + n - 1 + offset
        first, end = flash_mod.kv_tile_range(q0, rows, T, S, bk, causal, window, offset)
        for kt in range(first, end):
            k0 = kt * bk
            s = mm(qf[:, :, q0:q0 + n], kf[:, :, k0:k0 + bk].transpose(-1, -2)) * scale_log2
            if flash_mod.tile_needs_mask(k0, bk, S, q_lo, q_hi, causal, window):
                ok = _tile_mask(q0, n, k0, bk, S, offset, causal, window, q.device)
                s = torch.where(ok, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_use = torch.where(torch.isinf(m_new), 0.0, m_new)
            alpha = torch.exp2(m - m_use)
            pt = torch.exp2(s - m_use[..., None])
            l = l * alpha + pt.sum(dim=-1)
            acc = acc * alpha[..., None] + mm(pt, vf[:, :, k0:k0 + bk])
            m = m_new
        out[:, :, q0:q0 + n] = torch.where(l[..., None] > 0,
                                           acc / torch.where(l > 0, l, 1.0)[..., None], 0.0)
        lse[:, :, q0:q0 + n] = torch.where(
            l > 0, (m + torch.log2(torch.where(l > 0, l, 1.0))) * math.log(2), -math.inf)
    out = out.transpose(1, 2)
    return (out, lse.transpose(1, 2)) if return_lse else out


def flash_attention_bwd_tiled(q, k, v, out, dout, lse, *, causal: bool = True,
                              window: Optional[int] = None,
                              softmax_scale: Optional[float] = None,
                              q_offset: Optional[int] = None, matmul=None):
    """K1's gradient kernel in plain PyTorch, tile by tile: (dq, dk, dv) of
    ``out`` = flash_attention(q, k, v, ...) under ``dout``, from the fp32
    ``lse`` (B, T, Hq) the forward returned; shapes and masks as
    :func:`flash_attention_ref`'s.  Returns fp32.

    As ``csrc/flash_attention_bwd.cu`` computes it, with the tiles of
    ``flash_attention_bwd.plan`` for q's type: delta = rowsum(dO ∘ O); a
    dK/dV block per (key tile, query head) walks the query tiles that see
    its keys (``flash_attention.q_tile_range``) and accumulates
    dV += Pᵀ·dO and dK += dSᵀ·Q, with Sᵀ = K·Qᵀ, P = exp(S·scale − lse) (0
    where masked or where the row saw no key), dPᵀ = V·dOᵀ and
    dS = P ∘ (dP − delta), then dK ×= scale; the G query heads' partials of
    a KV head are summed in the order g = 0..G−1; a dQ block per 64-row
    query tile walks the key tiles it sees (``kv_tile_range``) for
    dQ += dS·K, times the scale.  For bf16 inputs P and dS are rounded to
    bf16 before their products, as the kernel does.  Every product goes
    through ``matmul`` (the fp32 kernel's is :func:`matmul_3xtf32`; the
    default is ``torch.matmul``)."""
    mm = matmul or torch.matmul
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    p = bwd_mod.plan(B, T, S, Hq, Hkv, D, q.dtype)
    scale = softmax_scale or 1.0 / math.sqrt(D)
    offset = S - T if q_offset is None else q_offset
    narrow = ((lambda x: x.to(q.dtype).float()) if q.dtype != torch.float32
              else (lambda x: x))
    qf, dof = q.float().transpose(1, 2), dout.float().transpose(1, 2)      # (B, Hq, T, D)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)            # (B, Hq, S, D)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)          # (B, Hq, T)
    lse = lse.float().transpose(1, 2)

    def probs(t0, t1, k0, k1):
        """P and dP (B, Hq, t1 - t0, k1 - k0) of query rows t0.. and keys k0..,
        computed as the kernel's (transposed) products are."""
        ok = _tile_mask(t0, t1 - t0, k0, k1 - k0, S, offset, causal, window, q.device)
        row_lse = lse[:, :, t0:t1, None]
        s = mm(kf[:, :, k0:k1], qf[:, :, t0:t1].transpose(-1, -2)).transpose(-1, -2)
        pt = torch.where(ok & (row_lse > -math.inf), torch.exp(s * scale - row_lse), 0.0)
        dp = mm(vf[:, :, k0:k1], dof[:, :, t0:t1].transpose(-1, -2)).transpose(-1, -2)
        return pt, dp

    dk = torch.zeros((B, S, Hkv, D), device=q.device)
    dv = torch.zeros((B, S, Hkv, D), device=q.device)
    bk, bq = p.block_keys, p.rows
    for k0 in range(0, S, bk):
        k1 = min(k0 + bk, S)
        dk_h = torch.zeros((B, Hq, k1 - k0, D), device=q.device)
        dv_h = torch.zeros((B, Hq, k1 - k0, D), device=q.device)
        first, end = flash_mod.q_tile_range(k0, bk, T, S, bq, causal, window, offset)
        for qt in range(first, end):
            t0, t1 = qt * bq, min(qt * bq + bq, T)
            pt, dp = probs(t0, t1, k0, k1)
            ds = pt * (dp - delta[:, :, t0:t1, None])
            dv_h += mm(narrow(pt).transpose(-1, -2), dof[:, :, t0:t1])
            dk_h += mm(narrow(ds).transpose(-1, -2), qf[:, :, t0:t1])
        dk_h, dv_h = (x.transpose(1, 2).reshape(B, k1 - k0, Hkv, G, D) for x in (dk_h * scale, dv_h))
        sum_k, sum_v = dk_h[..., 0, :], dv_h[..., 0, :]
        for g in range(1, G):                      # the partials, in the order g = 0..G-1
            sum_k, sum_v = sum_k + dk_h[..., g, :], sum_v + dv_h[..., g, :]
        dk[:, k0:k1], dv[:, k0:k1] = sum_k, sum_v
    dq = torch.zeros((B, Hq, T, D), device=q.device)
    for t0 in range(0, T, bwd_mod.DQ_ROWS):
        t1 = min(t0 + bwd_mod.DQ_ROWS, T)
        first, end = flash_mod.kv_tile_range(t0, bwd_mod.DQ_ROWS, T, S, p.dq_keys, causal,
                                             window, offset)
        for kt in range(first, end):
            k0, k1 = kt * p.dq_keys, min(kt * p.dq_keys + p.dq_keys, S)
            pt, dp = probs(t0, t1, k0, k1)
            ds = pt * (dp - delta[:, :, t0:t1, None])
            dq[:, :, t0:t1] += mm(narrow(ds), kf[:, :, k0:k1])
    return (dq * scale).transpose(1, 2), dk, dv


def _window_start(context_lens, window: Optional[int]):
    """First visible key of each context: ``context_len - window`` (at least
    0), or 0 without a window; the query sits at ``context_len - 1``."""
    if window is None:
        return torch.zeros_like(context_lens)
    return torch.clamp(context_lens - window, min=0)


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens, *,
                        window: Optional[int] = None,
                        softmax_scale: Optional[float] = None, return_lse: bool = False):
    """Decode attention against a paged KV pool.

    q:            (B, Hq, D)      — one query token per sequence
    k/v_pages:    (num_pages, page_size, Hkv, D)
    block_tables: (B, pages_per_seq) int32 — page ids per sequence
    context_lens: (B,) int32      — valid KV length per sequence
    window:       keys at positions < context_len − window are masked (the
                  Pallas kernel has no window; this is the dense attention's
                  ``causal_mask(window=)`` for a query at context_len − 1)
    returns       (B, Hq, D) (the mean of V for an empty context, as the
                  JAX package's); with ``return_lse`` also the fp32
                  log-sum-exp of each row's scaled scores (B, Hq), -inf for
                  an empty context
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
    lens = context_lens.to(q.device).long()
    pos = torch.arange(S, device=q.device)[None, :]
    valid = (pos < lens[:, None]) & (pos >= _window_start(lens, window)[:, None])
    masked = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(masked, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs.to(v.dtype), v).reshape(B, Hq, D)
    if not return_lse:
        return out
    lse = torch.logsumexp(torch.where(valid[:, None, None, :], scores, -torch.inf), dim=-1)
    return out, lse.reshape(B, Hq)


def paged_attention_split(q, k_pages, v_pages, block_tables, context_lens, *,
                          window: Optional[int] = None, partition: int = PARTITION,
                          softmax_scale: Optional[float] = None, return_lse: bool = False):
    """K2's algorithm in plain PyTorch: split each context into partitions of
    ``partition`` keys (a multiple of the page size; their number comes from
    ``pages_per_seq``, not from the lengths), take each partition's softmax
    statistics (m, l) and unnormalised sum acc = Σ exp(s − m)·v in fp32, then
    merge them exactly: o = Σ exp(m_i − M)·acc_i / Σ exp(m_i − M)·l_i over the
    non-empty partitions.  With a window, a partition that ends at or before
    ``context_len − window`` is empty, and the one that holds the window's
    start masks the keys before it.  An empty context gives 0 (as the Pallas
    kernel does; ``paged_attention_ref`` gives the mean of V there).  Shapes
    as :func:`paged_attention_ref`; returns (B, Hq, D) in q's type, and with
    ``return_lse`` the merge's lse = M + log Σ exp(m_i − M)·l_i (B, Hq),
    -inf for an empty context."""
    m, l, acc = paged_attention_partials(q, k_pages, v_pages, block_tables, context_lens,
                                         window=window, partition=partition,
                                         softmax_scale=softmax_scale)
    out = paged_attention_merge(m, l, acc).to(q.dtype)
    if not return_lse:
        return out
    M = m.amax(dim=-1)
    M0 = torch.where(torch.isinf(M), 0.0, M)
    den = (torch.where(torch.isinf(m), 0.0, torch.exp(m - M0[..., None])) * l).sum(dim=-1)
    return out, torch.where(den > 0, M0 + torch.log(torch.where(den > 0, den, 1.0)), -torch.inf)


def paged_attention_partials(q, k_pages, v_pages, block_tables, context_lens, *,
                             window: Optional[int] = None, partition: int = PARTITION,
                             softmax_scale: Optional[float] = None):
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
    pos = torch.arange(S, device=q.device)[None, :]
    valid = (pos < ctx[:, None]) & (pos >= _window_start(ctx, window)[:, None])
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


def ssd_scan_bwd_two_pass(xdt, dA, Bm, Cm, dy, *, chunk: int = 128, initial_state=None,
                          d_final=None):
    """The gradient of :func:`ssd_scan_chunked` as K3-bwd's passes in plain
    PyTorch; chunks are ``chunk`` long whatever T, a ragged tail padded with
    zeros.  With G_c the gradient of the state leaving chunk c, S_c the
    state entering it and cum the inclusive cumsum of dA inside it:

    1. the reverse state scan, from G = ``d_final`` (or 0) at the last chunk:
       G_{c-1} = exp(cum_last)·G_c + Σ_i exp(cum_i)·C_i ⊗ dy_i, which ends
       at the initial state's gradient;
    2. per (chunk, head), with M = L ∘ (dy·xdtᵀ) over the causal triangle:
       dxdt = (C·Bᵀ ∘ L)ᵀ·dy + (B ∘ w)·G_c, w_j = exp(cum_last − cum_j);
       dC_h = M·B + (dy ∘ exp(cum))·S_cᵀ;  dB_h = Mᵀ·C + (xdt ∘ w)·G_cᵀ;
       dcum_i = Σ_{j<i} (C·Bᵀ ∘ M)_ij − Σ_{k>i} (C·Bᵀ ∘ M)_ki
                + exp(cum_i)·dy_i·(S_cᵀ·C_i) − w_i·xdt_i·(G_cᵀ·B_i),
       plus ⟨G_c, S_{c+1}⟩ at the last position (the terms of
       C_i·dC_h,i − B_i·dB_h,i, whose diagonal cancels), and ddA is the
       reverse cumsum of dcum inside the chunk.  ddA sums many terms of
       both signs, so dcum is taken in fp64 from the fp32 inputs, states and
       state gradients (the kernel sums fp32 products in fp64);
    3. dB and dC summed over the heads in order, h = 0 .. H − 1.

    xdt (B,T,H,P), dA (B,T,H), Bm/Cm (B,T,N), dy (B,T,H,P); initial_state
    and d_final (B,H,N,P) or None.  Returns (dxdt, ddA, dBm, dCm, the
    initial state's gradient or None), all fp32."""
    B, T, H, P = xdt.shape
    N = Bm.shape[-1]
    Q = chunk
    pad = (-T) % Q
    nC = (T + pad) // Q
    CBt, cum, dS, decay = ssd_chunk_pass(xdt, dA, Bm, Cm, chunk=Q)
    x = F.pad(xdt.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nC, Q, H, P)
    g_y = F.pad(dy.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nC, Q, H, P)
    Bc = F.pad(Bm.float(), (0, 0, 0, pad)).reshape(B, nC, Q, N)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(B, nC, Q, N)
    # the states entering each chunk, and the last chunk's end state
    s = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    states = [s]
    for c in range(nC):
        states.append(states[-1] * decay[:, c, :, None, None] + dS[:, c])
    states = torch.stack(states, dim=1)                           # (B, C+1, H, N, P)

    # 1. the reverse state scan
    ecum = torch.exp(cum.float())                                 # (B,C,Q,H)
    dG = torch.einsum("bcin,bcih,bcihp->bchnp", Cc, ecum, g_y)
    g = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if d_final is None else d_final.float())
    G = [None] * nC
    for c in reversed(range(nC)):
        G[c] = g
        g = g * decay[:, c, :, None, None] + dG[:, c]
    G = torch.stack(G, dim=1)                                     # (B,C,H,N,P)

    # 2. per (chunk, head)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    delta = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).float()   # (B,C,i,j,H)
    L = torch.exp(torch.where(mask[None, None, :, :, None], delta,
                              torch.tensor(-torch.inf, device=x.device)))
    w = torch.exp((cum[:, :, -1:, :] - cum).float())              # (B,C,Q,H)
    M = L * torch.einsum("bcihp,bcjhp->bcijh", g_y, x)
    dx = (torch.einsum("bcji,bcijh,bcihp->bcjhp", CBt, L, g_y)
          + torch.einsum("bcjn,bcjh,bchnp->bcjhp", Bc, w, G))
    dC_h = (torch.einsum("bcijh,bcjn->bcihn", M, Bc)
            + torch.einsum("bcih,bcihp,bchnp->bcihn", ecum, g_y, states[:, :-1]))
    dB_h = (torch.einsum("bcijh,bcin->bcjhn", M, Cc)
            + torch.einsum("bcjh,bcjhp,bchnp->bcjhn", w, x, G))
    # dcum's terms in fp64 (from the fp32 inputs, states and state gradients)
    xd, yd, Bd, Cd, Gd, Sd = (t.double() for t in (x, g_y, Bc, Cc, G, states))
    CBM = (torch.einsum("bcin,bcjn->bcij", Cd, Bd)[..., None] * torch.exp(
        torch.where(mask[None, None, :, :, None], cum[:, :, :, None, :] - cum[:, :, None, :, :],
                    torch.tensor(-torch.inf, dtype=torch.float64, device=x.device)))
        * torch.einsum("bcihp,bcjhp->bcijh", yd, xd))
    CBM = CBM * (1 - torch.eye(Q, dtype=torch.float64, device=x.device))[None, None, :, :, None]
    dcum = (CBM.sum(3) - CBM.sum(2)
            + torch.exp(cum) * torch.einsum("bcin,bcihp,bchnp->bcih", Cd, yd, Sd[:, :-1])
            - torch.exp(cum[:, :, -1:, :] - cum) * torch.einsum("bcjn,bcjhp,bchnp->bcjh",
                                                                 Bd, xd, Gd))
    dcum[:, :, -1] += torch.einsum("bchnp,bchnp->bch", Gd, Sd[:, 1:])
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,)).float()

    # 3. the ordered sum over heads
    dBm, dCm = dB_h[:, :, :, 0], dC_h[:, :, :, 0]
    for h in range(1, H):
        dBm, dCm = dBm + dB_h[:, :, :, h], dCm + dC_h[:, :, :, h]
    return (dx.reshape(B, nC * Q, H, P)[:, :T], ddA.reshape(B, nC * Q, H)[:, :T],
            dBm.reshape(B, nC * Q, N)[:, :T], dCm.reshape(B, nC * Q, N)[:, :T],
            None if initial_state is None else g)


def ssd_scan_bwd_tiled(xdt, dA, Bm, Cm, dy, *, chunk: int = 128, initial_state=None,
                       d_final=None, group_heads: Optional[int] = None,
                       matmul=matmul_3xtf32):
    """The gradient of :func:`ssd_scan_chunked` as K3-bwd's kernels compute
    it (``csrc/ssd_scan_bwd.cu``), in plain PyTorch with every product
    through ``matmul`` (the kernels' 3xTF32 by default).  Chunks are
    ``chunk`` long whatever T, a ragged tail padded with zeros; 16-row strips
    of a chunk are the kernels' row tiles.  With cum the inclusive fp64
    cumsum of dA inside a chunk, ecum = exp(cum), w = exp(cum_last − cum),
    L[i,j] = exp(cum_i − cum_j) for i ≥ j, S_c the state entering chunk c
    and G_c the gradient of the state leaving it:

    1. ``ssd_bwd_chunk``: C·Bᵀ over the lower-triangular strips once per
       chunk; per head ΔG = Cᵀ·(ecum ∘ dy), the chunk's share of the state
       gradient;
    2. ``ssd_bwd_state``: G_{c-1} = exp(cum_last)·G_c + ΔG_c from G =
       ``d_final`` (or 0) at the last chunk, ending at the initial state's
       gradient;
    3. ``ssd_bwd_grads``, per (chunk, head): raw = dy·xdtᵀ over the
       triangle's strips and CBL = C·Bᵀ ∘ L; dcum's intra-chunk terms are the
       row sums of CBL ∘ raw left of the diagonal less its column sums below
       it; dxdt = CBLᵀ·dy (row strip j from depth j on) + w ∘ (B·G_c), whose
       state part gives dcum's term −⟨xdt_j, w_j (B·G_c)_j⟩, and dcum's other
       state term is ecum_i ⟨C_i, (dy·S_cᵀ)_i⟩, plus ⟨G_c, S_{c+1}⟩ at the
       last position; every dcum term is an fp32 product summed in fp64, and
       ddA is dcum's reverse cumsum;
    4. ``ssd_bwd_bc``, per (chunk, group of ``group_heads`` heads): the
       heads' sum inside the products, Msum = Σ_h L_h ∘ raw_h (fp32, heads in
       order), dC = Σ_h (ecum_h ∘ dy_h)·S_hᵀ + Msum·B and dB = Σ_h (w_h ∘
       xdt_h)·G_hᵀ + Msumᵀ·C; the groups' partials are summed in order.

    ``group_heads`` defaults to ``ssd_scan_bwd.plan``'s.  xdt (B,T,H,P), dA
    (B,T,H), Bm/Cm (B,T,N), dy (B,T,H,P); initial_state and d_final
    (B,H,N,P) or None.  Returns (dxdt, ddA, dBm, dCm, the initial state's
    gradient or None), all fp32."""
    from . import ssd_scan_bwd as ssd_bwd_mod
    B, T, H, P = xdt.shape
    N = Bm.shape[-1]
    Q = chunk
    pad = (-T) % Q
    nC = (T + pad) // Q
    hg = group_heads or ssd_bwd_mod.plan(B, T, H, P, N, chunk).group_heads
    strips = [(r, r + ssd_bwd_mod.STRIP) for r in range(0, Q, ssd_bwd_mod.STRIP)]
    dev = xdt.device
    x = F.pad(xdt.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nC, Q, H, P).permute(0, 1, 3, 2, 4)
    g_y = F.pad(dy.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nC, Q, H, P).permute(0, 1, 3, 2, 4)
    Bc = F.pad(Bm.float(), (0, 0, 0, pad)).reshape(B, nC, 1, Q, N)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(B, nC, 1, Q, N)
    cum = torch.cumsum(F.pad(dA.float(), (0, 0, 0, pad)).reshape(B, nC, Q, H).double(), dim=2)
    cum = cum.permute(0, 1, 3, 2)                                  # (B, C, H, Q)
    ecum = torch.exp(cum.float())
    w = torch.exp((cum[..., -1:] - cum).float())
    decay = torch.exp(cum[..., -1].float())                        # (B, C, H)
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    L = torch.exp(torch.where(tril, cum[..., :, None] - cum[..., None, :],
                              torch.tensor(-torch.inf, dtype=torch.float64, device=dev)).float())

    # 1. C·Bᵀ over the triangle's strips; each head's ΔG
    CB = torch.zeros((B, nC, 1, Q, Q), dtype=torch.float32, device=dev)
    for r0, r1 in strips:
        CB[..., r0:r1, :r1] = matmul(Cc[..., r0:r1, :], Bc[..., :r1, :].transpose(-1, -2))
    dG = matmul(Cc.transpose(-1, -2), ecum[..., None] * g_y)      # (B, C, H, N, P)

    # 2. the reverse state scan; the states from the forward's recurrence
    g = (torch.zeros((B, H, N, P), dtype=torch.float32, device=dev)
         if d_final is None else d_final.float())
    G = [None] * nC
    for c in reversed(range(nC)):
        G[c] = g
        g = g * decay[:, c, :, None, None] + dG[:, c]
    G = torch.stack(G, dim=1)
    dS = torch.einsum("bcjn,bchj,bchjp->bchnp", Bc[:, :, 0], w, x)
    s = (torch.zeros((B, H, N, P), dtype=torch.float32, device=dev)
         if initial_state is None else initial_state.float())
    states = [s]
    for c in range(nC):
        states.append(states[-1] * decay[:, c, :, None, None] + dS[:, c])
    states = torch.stack(states, dim=1)                            # (B, C+1, H, N, P)
    S_in, S_out = states[:, :-1], states[:, 1:]

    # 3. per (chunk, head): dxdt and ddA
    raw = torch.zeros((B, nC, H, Q, Q), dtype=torch.float32, device=dev)
    for r0, r1 in strips:
        raw[..., r0:r1, :r1] = matmul(g_y[..., r0:r1, :], x[..., :r1, :].transpose(-1, -2))
    CBL = torch.where(tril, CB * L, 0.0)
    v = torch.where(torch.tril(tril, -1), CBL * raw, 0.0).double()
    dcum = v.sum(-1) - v.sum(-2)
    dx = torch.zeros_like(x)
    for r0, r1 in strips:
        dx[..., r0:r1, :] = matmul(CBL[..., r0:, r0:r1].transpose(-1, -2), g_y[..., r0:, :])
    dx_state = w[..., None] * matmul(Bc, G)
    dx = dx + dx_state
    dcum -= (x.double() * dx_state.double()).sum(-1)
    ys = matmul(g_y, S_in.transpose(-1, -2))                       # (B, C, H, Q, N)
    dcum += ecum.double() * (Cc.double() * ys.double()).sum(-1)
    dcum[..., -1] += (G.double() * S_out.double()).sum((-1, -2))
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), dim=-1), (-1,)).float()

    # 4. per (chunk, group of heads): dB and dC with the heads summed inside
    M = torch.where(tril, raw * L, 0.0)
    dBm = dCm = None
    for h0 in range(0, H, hg):
        hs = range(h0, min(H, h0 + hg))
        msum = M[:, :, h0]
        for h in hs[1:]:
            msum = msum + M[:, :, h]
        pc = pb = None
        for h in hs:
            tc = matmul(ecum[:, :, h, :, None] * g_y[:, :, h], S_in[:, :, h].transpose(-1, -2))
            tb = matmul(w[:, :, h, :, None] * x[:, :, h], G[:, :, h].transpose(-1, -2))
            pc, pb = (tc, tb) if pc is None else (pc + tc, pb + tb)
        for r0, r1 in strips:
            pc[..., r0:r1, :] += matmul(msum[..., r0:r1, :r1], Bc[:, :, 0, :r1, :])
            pb[..., r0:r1, :] += matmul(msum[..., r0:, r0:r1].transpose(-1, -2),
                                        Cc[:, :, 0, r0:, :])
        dBm, dCm = (pb, pc) if dBm is None else (dBm + pb, dCm + pc)
    return (dx.permute(0, 1, 3, 2, 4).reshape(B, nC * Q, H, P)[:, :T],
            ddA.permute(0, 1, 3, 2).reshape(B, nC * Q, H)[:, :T],
            dBm.reshape(B, nC * Q, N)[:, :T], dCm.reshape(B, nC * Q, N)[:, :T],
            None if initial_state is None else g)
