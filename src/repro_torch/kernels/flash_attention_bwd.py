"""The gradient of K1: the CUDA kernel's wrapper.

The JAX package trains through its dense attention, which XLA
differentiates; it has no backward kernel.  The port trains through K1
(:mod:`repro_torch.kernels.flash_attention`), so K1 gets a gradient of its
own, ``csrc/flash_attention_bwd.cu``: from q, k, v, K1's output and its
fp32 log-sum-exp, the launches compute delta = rowsum(dO ∘ O), then dK and
dV (one block per key tile, query head and batch; with G > 1 query heads a
KV head each block writes an fp32 partial to scratch and one more launch
sums the G partials in a fixed order, so no atomics), then dQ (one block per
query tile, head and batch).  The masks are K1's: causal with query t at key
position ``q_offset + t`` (S − T by default) and an optional window, or none.
All five products run on the tensor cores as ``mma.sync``: bf16 as bf16
(P and dS rounded to bf16 for their products), fp32 as 3xTF32; sums in
fp32; fp32 or bf16 in and out.  :func:`plan` fixes tiles, grids and scratch
from the shapes alone.

:func:`flash_attention_bwd` launches on CUDA tensors and raises on what the
kernel does not take; it never falls back to the plain version.  The plain
version is autograd through :func:`repro_torch.kernels.ref.flash_attention_ref`,
and :func:`repro_torch.kernels.ref.flash_attention_bwd_tiled` spells out the
kernel's tiles, walks and partial sums in plain PyTorch.
``repro_torch.kernels.ops`` binds the two directions into one
``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .flash_attention import HEAD_DIMS, SMEM_LIMIT

WARPS = 4           # warps a block of every launch but delta: kWarps in the source
STAGES = 2          # tiles in flight in the cp.async rings: kStages
DQ_ROWS = 16 * WARPS    # query rows a dQ block: kDqRows
# (type, D) -> (query rows a dK/dV ring stage, warps that share 16 keys, keys
# a dQ ring stage): BwdTiles in the source, chosen at D = 128 with
# scripts/time_fp32_tiles.py.  Two blocks an SM where the shared memory
# allows it; at D = 256 two warps split dK's and dV's columns, whose
# accumulators would not fit one warp's registers.
TILES = {(torch.float32, 32): (32, 1, 64), (torch.float32, 64): (32, 1, 64),
         (torch.float32, 128): (16, 1, 16), (torch.float32, 256): (16, 2, 16),
         (torch.bfloat16, 32): (32, 1, 64), (torch.bfloat16, 64): (32, 1, 64),
         (torch.bfloat16, 128): (32, 1, 32), (torch.bfloat16, 256): (32, 2, 32)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAD = {torch.float32: 4, torch.bfloat16: 8}    # row padding: Mma<T>::kPad

launches = 0        # wrapper calls that launched the gradient's kernels (one gradient each)


class BwdPlan(NamedTuple):
    """How K1-bwd covers one call (see :func:`plan`)."""
    rows: int            # query rows a dK/dV ring stage
    split: int           # warps sharing 16 keys, each with D / split columns
    block_keys: int      # keys a dK/dV block: 16 * WARPS // split
    key_tiles: int       # key tiles along S
    dkdv_blocks: int     # key_tiles * Hq * B
    partial: bool        # G > 1: fp32 partials and a launch that sums them
    scratch_bytes: int   # the partials, (B, S, Hq, D) fp32 for dK and for dV
    dq_keys: int         # keys a dQ ring stage
    q_tiles: int         # query tiles of DQ_ROWS along T
    dq_blocks: int       # q_tiles * Hq * B
    dkdv_smem: int       # dynamic shared memory of a dK/dV block
    dq_smem: int         # and of a dQ block


def smem_bytes(dtype: torch.dtype, D: int) -> Tuple[int, int]:
    """Dynamic shared memory of a dK/dV block (K and V; the Q and dO ring;
    the lse and delta ring) and of a dQ block (Q and dO; the K and V ring;
    lse and delta): ``BwdTile::kDkdvSmem`` and ``kDqSmem``."""
    rows, split, dq_keys = TILES[(dtype, D)]
    ld = (D + _PAD[dtype]) * (4 if dtype == torch.float32 else 2)
    keys = 16 * WARPS // split
    return ((2 * keys + 2 * STAGES * rows) * ld + 2 * STAGES * rows * 4,
            (2 * DQ_ROWS + 2 * STAGES * dq_keys) * ld + 2 * DQ_ROWS * 4)


@functools.lru_cache(maxsize=4096)
def plan(B: int, T: int, S: int, Hq: int, Hkv: int, D: int, dtype: torch.dtype) -> BwdPlan:
    """K1-bwd's plan for one call, from plain integers (no device value is
    read, so the call can be captured in a CUDA graph)."""
    if (dtype, D) not in TILES:
        raise ValueError(f"flash_attention_bwd: no tiles for {dtype} at head_dim {D}")
    rows, split, dq_keys = TILES[(dtype, D)]
    block_keys = 16 * WARPS // split
    key_tiles = -(-S // block_keys)
    q_tiles = -(-T // DQ_ROWS)
    partial = Hq != Hkv
    dkdv_smem, dq_smem = smem_bytes(dtype, D)
    return BwdPlan(rows, split, block_keys, key_tiles, key_tiles * Hq * B, partial,
                   2 * B * S * Hq * D * 4 if partial else 0, dq_keys, q_tiles,
                   q_tiles * Hq * B, dkdv_smem, dq_smem)


def dkdv_block_coords(B: int, Hq: int, index: int) -> Tuple[int, int, int]:
    """(batch, query head, key tile) of dK/dV block ``index``, as the kernel
    decodes ``blockIdx.x``: key tiles from the first (under the causal mask
    the one seen by the most query tiles) to the last, within a tile the
    heads, then the batch."""
    per_tile = Hq * B
    rest = index % per_tile
    return rest // Hq, rest % Hq, index // per_tile


def dq_block_coords(p: BwdPlan, B: int, Hq: int, index: int) -> Tuple[int, int, int]:
    """(batch, query head, query tile) of dQ block ``index``: query tiles
    from the last (the one that sees the most keys) to the first."""
    per_tile = Hq * B
    rest = index % per_tile
    return rest // Hq, rest % Hq, p.q_tiles - 1 - index // per_tile


@functools.cache
def _kernel():
    lib = _build.load("flash_attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.flash_attention_bwd
    fn.argtypes = [i] + [p] * 12 + [i] * 6 + [ctypes.c_float, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, softmax_scale: Optional[float] = None,
                        q_offset: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of K1's output ``out`` = flash_attention(q, k, v, ...)
    under the upstream gradient ``dout``, from K1's fp32 ``lse`` (B, T, Hq).

    q, out, dout: (B, T, Hq, D); k, v: (B, S, Hkv, D); all dense CUDA tensors
    of one type, fp32 or bf16; D in {32, 64, 128, 256}; Hq a multiple of
    Hkv.  The mask arguments are K1's.  Returns gradients in q's type.
    Launches on the current stream without synchronising."""
    global launches
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout), ("lse", lse)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention_bwd: {name} is on {x.device}; the kernel "
                             "takes CUDA tensors (the plain version is autograd through "
                             "repro_torch.kernels.ref.flash_attention_ref)")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be dense, got strides "
                             f"{tuple(x.stride())}")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be 16-byte aligned")
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in (k, v, out, dout)):
        raise ValueError(f"flash_attention_bwd: q, k, v, out, dout must share one type of "
                         f"float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}, "
                         f"{out.dtype}, {dout.dtype}")
    if lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32, got {lse.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention_bwd: q and k must be 4-D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if (v.shape != k.shape or k.shape[0] != B or k.shape[3] != D or out.shape != q.shape
            or dout.shape != q.shape or lse.shape != (B, T, Hq)):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {D} not in {HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"flash_attention_bwd: {Hq} query heads over {Hkv} KV heads")
    if T < 1 or S < 1 or (causal and q_offset is None and S < T):
        raise ValueError(f"flash_attention_bwd: needs 1 <= T <= S when causal, "
                         f"got T={T}, S={S}")
    if q_offset is not None and not 0 <= q_offset < 2**31 - T:
        raise ValueError(f"flash_attention_bwd: q_offset {q_offset} must be >= 0")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bwd: window must be >= 1, got {window}")
    if B > 65535 or Hq > 65535:
        raise ValueError("flash_attention_bwd: batch and heads must be <= 65535")
    p = plan(B, T, S, Hq, Hkv, D, q.dtype)
    if max(p.dkdv_smem, p.dq_smem) > SMEM_LIMIT:
        raise ValueError(f"flash_attention_bwd: {max(p.dkdv_smem, p.dq_smem)} bytes of shared "
                         f"memory, more than the {SMEM_LIMIT} a block may have")
    offset = S - T if q_offset is None else q_offset
    scale = softmax_scale or 1.0 / math.sqrt(D)
    win = window if (causal and window is not None) else 0
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, T, Hq), dtype=torch.float32, device=q.device)
    part = (torch.empty((2, B, S, Hq, D), dtype=torch.float32, device=q.device)
            if p.partial else None)
    parts = (part[0].data_ptr(), part[1].data_ptr()) if p.partial else (None, None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), *parts, B, T, S, Hq, Hkv, D, scale,
                    int(causal), win, offset, stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd: launch failed with CUDA error {err}")
    launches += 1
    return dq, dk, dv
