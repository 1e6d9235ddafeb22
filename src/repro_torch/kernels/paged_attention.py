"""Paged decode attention: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/paged_attention.py::paged_attention``
(``_paged_kernel``): one query token per sequence attends over a paged KV
pool through a block table; the G query heads of a KV head are handled
together, pages at or past ``context_len`` are skipped and positions past it
are masked inside the last page.  Beyond the Pallas kernel it takes a
sliding ``window``: keys before ``context_len - window`` are skipped by
whole partitions and masked inside the partition that holds the window's
start.

On the card the work is bound by bytes: each step reads every K/V byte of
every context once and does two FLOPs per byte.  The kernel splits each
context into partitions of :data:`PARTITION` keys (flash-decoding): one
block per (partition, KV head, sequence) reads each K/V row once for all G
query heads, gathering pages through the table with ``cp.async`` into a
two-stage ring, and writes fp32 partials (m, l, acc); a second launch merges
them exactly.  The partition count comes from ``pages_per_seq``
(:func:`plan`), never from ``context_lens``, so the wrapper reads no device
value and a decode step stays capturable in a CUDA graph.  The source is
``csrc/paged_attention.cu``.

:func:`paged_attention` launches the kernels on a CUDA tensor and raises on
what they do not take; it never falls back to the plain version.  The plain
version is :func:`repro_torch.kernels.ref.paged_attention_ref`, and
:func:`repro_torch.kernels.ref.paged_attention_split` is the same split and
merge in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

HEAD_DIMS = (32, 64, 128, 256)
PAGE_SIZES = (8, 16, 32)
MAX_GROUP_ELEMS = 4096      # G * D the kernel's accumulator holds
PARTITION = 64              # keys a block of the first launch covers: kPartition in the source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0        # wrapper calls that launched the kernels since the last reset


def plan(pages_per_seq: int, page_size: int) -> int:
    """Number of partitions a sequence is split into: enough to cover
    ``pages_per_seq * page_size`` keys, the longest context the table can
    hold.  Plain integers in, so no device value is read."""
    if PARTITION % page_size:
        raise ValueError(f"paged_attention: the partition ({PARTITION}) must be a "
                         f"multiple of the page size ({page_size})")
    return max(1, -(-pages_per_seq * page_size // PARTITION))


def scratch_shapes(B: int, Hq: int, D: int, num_parts: int):
    """Shapes of the fp32 partials (m, l, acc) between the two launches."""
    return (B, Hq, num_parts), (B, Hq, num_parts), (B, Hq, num_parts, D)


@functools.cache
def _kernel():
    fn = _build.load("paged_attention").paged_attention_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 9 + [i] * 7 + [ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor, context_lens: torch.Tensor, *,
                    window: Optional[int] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    q:            (B, Hq, D)
    k/v_pages:    (num_pages, page_size, Hkv, D)
    block_tables: (B, pages_per_seq) int32; every entry a valid page id
    context_lens: (B,) int32
    window:       None, or a sliding window of at least 1 key: keys at
                  positions < context_len - window are masked
    returns       (B, Hq, D) in q's type

    CUDA tensors only, all dense: fp32 or bf16, D in {32, 64, 128, 256}, page
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
    if B > 65535 or Hq > 65535:
        raise ValueError("paged_attention: batch and heads must be <= 65535")
    if window is not None and not 1 <= window < 2**31:
        raise ValueError(f"paged_attention: window {window} must be at least 1")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be 16-byte aligned")
    scale = softmax_scale or 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    if B == 0:
        return out
    pps = block_tables.shape[1]
    num_parts = plan(pps, page_size)
    # the three partials in one allocation, m then l then acc (fp32)
    sizes = [math.prod(shape) for shape in scratch_shapes(B, Hq, D, num_parts)]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=q.device)
    m_ptr = scratch.data_ptr()
    l_ptr = m_ptr + 4 * sizes[0]
    acc_ptr = l_ptr + 4 * sizes[1]
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), context_lens.data_ptr(), m_ptr, l_ptr, acc_ptr,
             out.data_ptr(), B, Hq, Hkv, D, page_size,
             pps, window or 0, scale, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention: launch failed with CUDA error {err}")
    launches += 1
    return out
