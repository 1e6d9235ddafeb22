"""The gradient of K3, the Mamba2 chunked SSD scan: the CUDA kernel's wrapper.

The JAX package trains its SSD layers through the jnp chunked scan
(``repro.models.layers.ssd_chunked_ref``), which XLA differentiates; its
Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan`` has no gradient.  The
port trains through K3 (:mod:`repro_torch.kernels.ssd_scan`), so K3 gets a
gradient of its own, ``csrc/ssd_scan_bwd.cu``, whose products all run on
the tensor cores as 3xTF32 ``mma.sync`` (fp32 accuracy), in four launches
and a fifth when the heads are cut into groups: ``ssd_bwd_chunk`` (C·Bᵀ over
the causal triangle once per chunk; per (chunk, head) the chunk's share of
the state gradient, and the cumsum of dA with its exponentials);
``ssd_bwd_state`` (the reverse scan of the state gradient); ``ssd_bwd_grads``
(per (chunk, head) dxdt and ddA); ``ssd_bwd_bc`` (dB and dC with the sum
over heads taken inside the products, per (chunk, group of heads, half of
the state columns)); and ``ssd_bwd_group_sum``, which adds the groups'
partials in order.  No atomics: the same bits every run.  The states around
each chunk are the ones K3's forward computed (the ``carry`` that
``ssd_scan`` returns), kept rather than recomputed.  fp32 or bf16 in, fp32
gradients out.

:func:`plan` lays each call out from its shapes alone: the tiles of P and N
each kernel stages, the head groups of ``ssd_bwd_bc`` and the shared memory
of each launch.  :func:`ssd_scan_bwd` launches on CUDA tensors and raises on
what the kernel does not take; it never falls back to the plain version.
The plain version is autograd through
:func:`repro_torch.kernels.ref.ssd_scan_chunked`, and
:func:`repro_torch.kernels.ref.ssd_scan_bwd_tiled` spells out the kernels'
passes, triangle strips and head groups in plain PyTorch with the same
3xTF32 products.  ``repro_torch.kernels.ops`` binds K3 and this gradient
into one ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from . import _build
from .ssd_scan import _DTYPES, COL_TILE, MAX_CHUNK, MAX_STATE, ROW_BLOCK, col_tile, n_chunks

launches = 0        # wrapper calls that launched the gradient's kernels (one gradient each)

THREADS = 256       # threads of a block of ssd_bwd_chunk
WIDE = 512          # threads of a block of ssd_bwd_grads and ssd_bwd_bc
WIDE_WARPS = WIDE // 32     # 16: 4 pairs of strips x 4 quarters of columns
STRIP = 16          # rows of an mma tile: a chunk is cut into strips of 16 positions
HALF = 64           # widest column half of N in ssd_bwd_bc
PARTS = 16          # fp64 rows of dcum's partial sums in ssd_bwd_grads
SMEM_LIMIT = 232448     # shared memory a block may use on an H100
SMS = 132           # an H100's SMs: ssd_bwd_bc cuts the heads into groups to fill them


@dataclass(frozen=True)
class Plan:
    chunks: int         # chunks of the sequence
    n8: int             # N rounded up to a multiple of 8 (zeros in shared memory)
    p_tile: int         # columns of P a block of ssd_bwd_chunk or ssd_bwd_grads stages
    p_slice: int        # depth of P a stage of ssd_bwd_bc's ring holds
    halves: int         # column halves of N in ssd_bwd_bc
    groups: int         # head groups of ssd_bwd_bc
    group_heads: int    # heads of a group (the last may hold fewer)
    chunk_smem: int     # dynamic shared memory of each launch, bytes
    grads_smem: int
    bc_smem: int
    partial_floats: int     # fp32 partials of dB and dC each (0 with one group)


def round8(n: int) -> int:
    return -(-n // 8) * 8


def slice_width(P: int) -> int:
    """Depth of P that a stage of ssd_bwd_bc's ring holds."""
    return 32 if P % 32 == 0 else 16


def smem_bytes(Q: int, n8: int, pt: int, ps: int, hw: int) -> Tuple[int, int, int]:
    """Dynamic shared memory of ssd_bwd_chunk, ssd_bwd_grads and ssd_bwd_bc,
    as the source computes it (``chunk_smem``, ``grads_smem``, ``bc_smem``).
    Rows are padded by 4 floats where a fragment reads along them and by 8
    where it reads across them, so that the 32 lanes hit 32 banks."""
    chunk = 12 * Q + 4 * max((min(Q, 64) + Q) * (n8 + 4), Q * (n8 + 8) + Q * (pt + 8))
    region0 = max(Q * (Q + 4), (Q + n8) * (pt + 4))
    grads = 16 * Q + 8 * (PARTS * Q + WIDE_WARPS) + 4 * (
        region0 + Q * (pt + 4) + Q * (max(pt, n8) + 4) + n8 * (pt + 8))
    ring = 2 * (2 * Q * (ps + 4) + 2 * hw * (ps + 4) + 4 * Q)
    bc = 4 * (Q * (Q + 4) + max(ring, 2 * Q * (hw + 8)))
    return chunk, grads, bc


def plan(B: int, T: int, H: int, P: int, N: int, chunk: int) -> Plan:
    """K3-bwd's layout for one call, from plain integers (no device value is
    read, so the call can be captured in a CUDA graph).  ssd_bwd_bc runs a
    block per (sequence, chunk, group of heads, half of N); the heads are cut
    into as many groups as keep the blocks within one wave of an H100's SMs,
    one group when the chunks alone fill it (mamba2_370m's training shape:
    128 blocks, no partials)."""
    nc = n_chunks(T, chunk)
    n8 = round8(N)
    pt, ps = col_tile(P), slice_width(P)
    hw = min(HALF, n8)
    halves = -(-n8 // HALF)
    per_group = halves * nc * B
    hg = -(-H // max(1, min(H, SMS // per_group)))
    groups = -(-H // hg)
    chunk_smem, grads_smem, bc_smem = smem_bytes(chunk, n8, pt, ps, hw)
    return Plan(nc, n8, pt, ps, halves, groups, hg, chunk_smem, grads_smem, bc_smem,
                0 if groups == 1 else B * nc * groups * chunk * N)


def head_groups(p: Plan, H: int) -> List[Tuple[int, int]]:
    """[h0, h1) of each head group of ssd_bwd_bc, in the order of the
    partials' sum."""
    return [(h0, min(H, h0 + p.group_heads)) for h0 in range(0, H, p.group_heads)]


def tri_tiles(strips: int) -> List[List[Tuple[int, int]]]:
    """The 16 x 8 tiles (strip, column tile) of a chunk's causal triangle
    that each of the 16 warps owns in ssd_bwd_grads and ssd_bwd_bc (``roles``
    and ``tri_product`` in the source): warp (pair, q) takes the strips lo =
    pair and hi = strips − 1 − pair (lo alone for the middle strip of an odd
    count; none for pair ≥ ceil(strips / 2)), and of each the column tiles
    nt ≡ q (mod 4) left of the strip's end; a warp's intra-chunk products
    that are triangular in their depth take the same strips."""
    out = []
    for warp in range(WIDE_WARPS):
        lo, q = warp >> 2, warp & 3
        hi = strips - 1 - lo
        tiles = []
        for r in ([lo, hi] if lo < hi else [lo] if lo == hi else []):
            tiles += [(r, nt) for nt in range(q, 2 * (r + 1), 4)]
        out.append(tiles)
    return out


def scratch_shapes(B: int, T: int, H: int, P: int, N: int, chunk: int):
    """Shapes of the fp32 scratch: C·Bᵀ of each chunk (transposed), the
    state gradient (each chunk's own share, then the gradient leaving it),
    each (chunk, head)'s cumsum of dA (fp64, as two floats a value) with
    exp(cum) and exp(cum_last − cum), each chunk's decay, and the groups'
    partials of dB and dC (empty with one group)."""
    p = plan(B, T, H, P, N, chunk)
    nc = p.chunks
    return ((B, nc, chunk, chunk), (B, nc, H, N, P), (B, nc, H, 4 * chunk), (B, nc, H),
            (p.partial_floats,), (p.partial_floats,))


@functools.cache
def _kernel():
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 20 + [i] * 7 + [ll] * 10 + [i, p]
    fn.restype = ctypes.c_int
    return fn


def _dense_state(name, x, shape):
    if tuple(x.shape) != shape or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"ssd_scan_bwd: {name} must be dense fp32 of shape {shape}, got "
                         f"{x.dtype} {tuple(x.shape)}")


def ssd_scan_bwd(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dy: torch.Tensor, carry: torch.Tensor, final_state: torch.Tensor, *,
                 chunk: int = 128, initial_state: Optional[torch.Tensor] = None,
                 d_final: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """The gradient of ``ssd_scan(xdt, dA, Bm, Cm, chunk=, initial_state=)``
    under ``dy`` (B, T, H, P) and ``d_final`` (B, H, N, P) or None (zero),
    given the ``carry`` (B, chunks, H, N, P) and ``final_state`` (B, H, N, P)
    that :func:`repro_torch.kernels.ssd_scan.ssd_scan` returned for the same
    inputs.
    Returns (dxdt, ddA, dBm, dCm, the initial state's gradient or None), fp32
    and dense.

    CUDA tensors only.  xdt, dA, Bm, Cm as K3's forward takes them; dy, the
    states and d_final dense fp32.  Launches on the current stream without
    synchronising."""
    global launches
    named = [("xdt", xdt), ("dA", dA), ("Bm", Bm), ("Cm", Cm), ("dy", dy), ("carry", carry),
             ("final_state", final_state)]
    named += [(n, x) for n, x in (("initial_state", initial_state), ("d_final", d_final))
              if x is not None]
    for name, x in named:
        if x.device.type != "cuda":
            raise ValueError(f"ssd_scan_bwd: {name} is on {x.device}; the kernel takes "
                             "CUDA tensors (the plain version is autograd through "
                             "repro_torch.kernels.ref.ssd_scan_chunked)")
    if xdt.dim() != 4 or dA.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError(f"ssd_scan_bwd: expected xdt 4-D and dA, Bm, Cm 3-D, got "
                         f"{tuple(xdt.shape)}, {tuple(dA.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, T, H, P = xdt.shape
    N = Bm.shape[-1]
    if tuple(dA.shape) != (B, T, H) or tuple(Bm.shape) != (B, T, N) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan_bwd: shapes xdt {tuple(xdt.shape)}, dA {tuple(dA.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)} disagree")
    if any(x.dtype != xdt.dtype for x in (dA, Bm, Cm)) or xdt.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan_bwd: xdt, dA, Bm, Cm must share one type of "
                         f"{list(_DTYPES)}, got {[x.dtype for x in (xdt, dA, Bm, Cm)]}")
    for name, x in (("xdt", xdt), ("Bm", Bm), ("Cm", Cm)):
        if x.stride(-1) != 1:
            raise ValueError(f"ssd_scan_bwd: the last axis of {name} must be dense, "
                             f"got strides {tuple(x.stride())}")
    if T < 1:
        raise ValueError(f"ssd_scan_bwd: needs T >= 1, got T={T}")
    if P % COL_TILE or N % 4 or not 4 <= N <= MAX_STATE:
        raise ValueError(f"ssd_scan_bwd: needs P a multiple of {COL_TILE} and N a multiple "
                         f"of 4 up to {MAX_STATE}, got P={P}, N={N}")
    if chunk % ROW_BLOCK or not ROW_BLOCK <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan_bwd: chunk must be a multiple of {ROW_BLOCK} up to "
                         f"{MAX_CHUNK}, got {chunk}")
    p = plan(B, T, H, P, N, chunk)
    if B > 65535 or H > 65535 or p.chunks > 65535:
        raise ValueError("ssd_scan_bwd: batch, chunks and heads must be <= 65535")
    _dense_state("dy", dy, (B, T, H, P))
    _dense_state("carry", carry, (B, p.chunks, H, N, P))
    _dense_state("final_state", final_state, (B, H, N, P))
    for name, x in (("initial_state", initial_state), ("d_final", d_final)):
        if x is not None:
            _dense_state(name, x, (B, H, N, P))
    dev = xdt.device
    dx = torch.empty((B, T, H, P), dtype=torch.float32, device=dev)
    ddA = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    dB = torch.empty((B, T, N), dtype=torch.float32, device=dev)
    dC = torch.empty((B, T, N), dtype=torch.float32, device=dev)
    d_init = None if initial_state is None else torch.empty_like(initial_state)
    # the scratch in one fp32 allocation: CB, G, cum with its exponentials,
    # decay, dB's and dC's partials; each part starts 16 bytes aligned
    sizes = [-(-math.prod(shape) // 4) * 4 for shape in scratch_shapes(B, T, H, P, N, chunk)]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    ptrs = [scratch.data_ptr() + 4 * sum(sizes[:k]) for k in range(len(sizes))]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
        carry.data_ptr(), None if initial_state is None else initial_state.data_ptr(),
        final_state.data_ptr(), None if d_final is None else d_final.data_ptr(),
        *ptrs, dx.data_ptr(), ddA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        None if d_init is None else d_init.data_ptr(),
        B, T, H, P, N, chunk, p.group_heads,
        xdt.stride(0), xdt.stride(1), xdt.stride(2), dA.stride(0), dA.stride(1), dA.stride(2),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
        _DTYPES[xdt.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd: launch failed with CUDA error {err}")
    launches += 1
    return dx, ddA, dB, dC, d_init
