"""Paged decode attention: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/paged_attention.py::paged_attention``
(``_paged_kernel``): one query token per sequence attends over a paged KV
pool through a block table; the G query heads of a KV head are handled
together, pages at or past ``context_len`` are skipped and positions past it
are masked inside the last page.

On the card the work is bound by bytes: each step reads every K/V byte of
every context once and does two FLOPs per byte.  The kernel reads each K/V
row once per (KV head, sequence) for all G query heads together, so the KV
bytes are not multiplied by G, and gathers pages directly from the pool
through the table without a copy.  One block per (KV head, sequence) leaves
SMs idle at small batch; splitting contexts across blocks is later work.  The
source is ``csrc/paged_attention.cu``.

:func:`paged_attention` launches the kernel on a CUDA tensor and raises on
what the kernel does not take; it never falls back to the plain version.
The plain version is :func:`repro_torch.kernels.ref.paged_attention_ref`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

HEAD_DIMS = (32, 64, 128)
PAGE_SIZES = (8, 16, 32)
MAX_GROUP_ELEMS = 2048      # G * D the kernel's accumulator holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0        # kernel launches since the last reset (plain integer)


@functools.cache
def _kernel():
    fn = _build.load("paged_attention").paged_attention_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor, context_lens: torch.Tensor, *,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    q:            (B, Hq, D)
    k/v_pages:    (num_pages, page_size, Hkv, D)
    block_tables: (B, pages_per_seq) int32; every entry a valid page id
    context_lens: (B,) int32
    returns       (B, Hq, D) in q's type

    CUDA tensors only, all dense: fp32 or bf16, D in {32, 64, 128}, page
    size in {8, 16, 32}, Hq a multiple of Hkv.  Launches on the current
    stream without synchronising."""
    global launches
    tensors = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("block_tables", block_tables), ("context_lens", context_lens))
    for name, x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"paged_attention: {name} is on {x.device}; the "
                             "kernel takes CUDA tensors (the plain version is "
                             "repro_torch.kernels.ref.paged_attention_ref)")
        if not x.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention: q and the pages must share one type "
                         f"of {list(_DTYPES)}, got {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("paged_attention: block_tables and context_lens must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)}")
    B, Hq, D = q.shape
    _, page_size, Hkv, Dk = k_pages.shape
    if Dk != D or D not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {D} (pages {Dk}) not in {HEAD_DIMS}")
    if page_size not in PAGE_SIZES:
        raise ValueError(f"paged_attention: page size {page_size} not in {PAGE_SIZES}")
    if Hq % Hkv or (Hq // Hkv) * D > MAX_GROUP_ELEMS:
        raise ValueError(f"paged_attention: {Hq} query heads over {Hkv} KV heads "
                         f"at D={D} (G*D must be <= {MAX_GROUP_ELEMS})")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or tuple(context_lens.shape) != (B,)):
        raise ValueError(f"paged_attention: block_tables {tuple(block_tables.shape)} "
                         f"and context_lens {tuple(context_lens.shape)} must cover B={B}")
    if B > 65535:
        raise ValueError("paged_attention: batch must be <= 65535")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be 16-byte aligned")
    scale = softmax_scale or 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
             B, Hq, Hkv, D, page_size, block_tables.shape[1], scale,
             _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention: launch failed with CUDA error {err}")
    launches += 1
    return out
