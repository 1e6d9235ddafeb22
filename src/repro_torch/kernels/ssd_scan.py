"""Mamba2 chunked SSD scan: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``
(``_ssd_kernel``): per chunk of Q positions, the intra-chunk quadratic term
``(C·Bᵀ ∘ L)·xdt`` plus the carried state's term ``exp(cum)·C·S``, then the
state update ``S ← exp(cum_Q)·S + Bᵀ·(exp(cum_Q − cum) ∘ xdt)``.  Unlike the
Pallas kernel it takes an ``initial_state`` (chunked prefill carries the
layer's state from one call to the next) and any T >= 1: a ragged last chunk
is masked, which is exact (a masked position multiplies the state by exp(0)
and adds nothing).

On the card the work is bound by operations (at the mamba2_370m prefill
shape, about 60 FLOPs per byte moved).  The kernel is the chunked-SSD
decomposition in two launches, both parallel over chunks: the first
computes C·Bᵀ once per chunk and each (chunk, head)'s own state
contribution ΔS into fp32 scratch; in the second each chunk takes its
starting state by a look-back that never waits (the end state the nearest
earlier chunk has published, plus the ΔS of the chunks in between), publishes
its own end state, and produces y as one product of depth Q + N.  Products are fp32 on the CUDA cores, register-tiled, to hold the
plain version to 2e-4.  The source is ``csrc/ssd_scan.cu``.

:func:`ssd_scan` launches the kernels on CUDA tensors and raises on what they
do not take; it never falls back to the plain version.  The plain version is
:func:`repro_torch.kernels.ref.ssd_scan_chunked`, and
:func:`repro_torch.kernels.ref.ssd_scan_two_pass` is the kernel's two passes
in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build

MAX_CHUNK = 128             # longest chunk; a multiple of ROW_BLOCK
MAX_STATE = 128             # largest N
ROW_BLOCK = 16              # chunk lengths are multiples of this
COL_TILE = 16               # P is a multiple of this
COL_TILES = (64, 32, 16)    # state columns a block may own
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0        # wrapper calls that launched the kernels since the last reset


def n_chunks(T: int, chunk: int) -> int:
    return -(-T // chunk)


def col_tile(P: int) -> int:
    """State columns a block owns: the widest tile that divides P.  On the
    H100 at the mamba2_370m prefill shapes the widest tile was the fastest
    even where it leaves SMs idle (T = 379: 96 blocks), since the narrower
    ones repeat the weighting of C·Bᵀ for every tile (PERF.md)."""
    return next(pt for pt in COL_TILES if P % pt == 0)


def scratch_shapes(B: int, T: int, H: int, P: int, N: int, chunk: int):
    """Shapes of the scratch between and within the two launches: AT (C·Bᵀ
    transposed over Cᵀ, per chunk), dS (each chunk's state contribution per
    head), carry (each chunk's published end state), decay (exp of each
    chunk's summed dA per head), all fp32, and the int32 flags that say a
    chunk's end state is published, one per (chunk, head, column tile)."""
    nc = n_chunks(T, chunk)
    return ((B, nc, chunk + N, chunk), (B, nc, H, N, P), (B, nc, H, N, P), (B, nc, H),
            (B, nc, H, P // col_tile(P)))


@functools.cache
def _kernel():
    fn = _build.load("ssd_scan").ssd_scan_fwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 12 + [i] * 7 + [ll] * 10 + [i, p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 128, initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt: (B, T, H, P) dt-premultiplied inputs; dA: (B, T, H) log decays;
    Bm, Cm: (B, T, N); initial_state: (B, H, N, P) or None (zeros).
    Returns (y (B, T, H, P) fp32, final state (B, H, N, P) fp32).

    CUDA tensors only.  xdt, dA, Bm and Cm share one type, fp32 or bf16, and
    may be strided views (slices of one projection) as long as their last
    axis is dense; initial_state is fp32 and dense.  T >= 1, P a multiple of
    16, N a multiple of 4 and <= 128, ``chunk`` a multiple of 16 and <= 128.
    Launches on the current stream without synchronising."""
    global launches
    named = [("xdt", xdt), ("dA", dA), ("Bm", Bm), ("Cm", Cm)]
    if initial_state is not None:
        named.append(("initial_state", initial_state))
    for name, x in named:
        if x.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} is on {x.device}; the kernel takes "
                             "CUDA tensors (the plain version is "
                             "repro_torch.kernels.ref.ssd_scan_chunked)")
    if xdt.dim() != 4 or dA.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError(f"ssd_scan: expected xdt 4-D and dA, Bm, Cm 3-D, got "
                         f"{tuple(xdt.shape)}, {tuple(dA.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, T, H, P = xdt.shape
    N = Bm.shape[-1]
    if tuple(dA.shape) != (B, T, H) or tuple(Bm.shape) != (B, T, N) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: shapes xdt {tuple(xdt.shape)}, dA {tuple(dA.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)} disagree")
    if any(x.dtype != xdt.dtype for _, x in named[:4]) or xdt.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: xdt, dA, Bm, Cm must share one type of "
                         f"{list(_DTYPES)}, got {[x.dtype for _, x in named[:4]]}")
    for name, x in (("xdt", xdt), ("Bm", Bm), ("Cm", Cm)):
        if x.stride(-1) != 1:
            raise ValueError(f"ssd_scan: the last axis of {name} must be dense, "
                             f"got strides {tuple(x.stride())}")
    if T < 1:
        raise ValueError(f"ssd_scan: needs T >= 1, got T={T}")
    if P % COL_TILE or N % 4 or not 4 <= N <= MAX_STATE:
        raise ValueError(f"ssd_scan: needs P a multiple of {COL_TILE} and N a multiple "
                         f"of 4 up to {MAX_STATE}, got P={P}, N={N}")
    if chunk % ROW_BLOCK or not ROW_BLOCK <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk must be a multiple of {ROW_BLOCK} up to "
                         f"{MAX_CHUNK}, got {chunk}")
    if B > 65535 or H > 65535 or B * n_chunks(T, chunk) > 65535:
        raise ValueError("ssd_scan: batch, heads and batch x chunks must be <= 65535")
    if initial_state is not None:
        if (tuple(initial_state.shape) != (B, H, N, P)
                or initial_state.dtype != torch.float32
                or not initial_state.is_contiguous()):
            raise ValueError(f"ssd_scan: initial_state must be dense fp32 of shape "
                             f"{(B, H, N, P)}, got {initial_state.dtype} "
                             f"{tuple(initial_state.shape)}")
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=xdt.device)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=xdt.device)
    # the scratch in one allocation of 4-byte words: AT, dS, carry, decay
    # (fp32), then the flags (int32); the sizes of AT and dS are multiples of
    # 16 values, so dS and carry stay 64-byte aligned
    sizes = [math.prod(shape) for shape in scratch_shapes(B, T, H, P, N, chunk)]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=xdt.device)
    at_ptr, ds_ptr, carry_ptr, decay_ptr, flags_ptr = (
        scratch.data_ptr() + 4 * sum(sizes[:k]) for k in range(5))
    fn = _kernel()
    stream = torch.cuda.current_stream(xdt.device).cuda_stream
    err = fn(xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             initial_state.data_ptr() if initial_state is not None else None,
             at_ptr, ds_ptr, carry_ptr, decay_ptr, flags_ptr, y.data_ptr(), state.data_ptr(),
             B, T, H, P, N, chunk, col_tile(P),
             xdt.stride(0), xdt.stride(1), xdt.stride(2),
             dA.stride(0), dA.stride(1), dA.stride(2),
             Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
             _DTYPES[xdt.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan: launch failed with CUDA error {err}")
    launches += 1
    return y, state
