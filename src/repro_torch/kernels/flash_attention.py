"""Flash attention for prefill and chunked prefill: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_kernel``): causal GQA attention whose queries are the last T of S
keys, with an optional sliding window, fp32 running max/sum/accumulator and
a default scale of 1/sqrt(D).  Beyond the Pallas kernel, the queries may sit
anywhere: query t at key position ``q_offset + t`` (``S - T`` by default),
and the kernel returns each row's log-sum-exp on request.  The deferred KV
append attends over a cached prefix and the new chunk as two such segments
and merges them (``repro_torch.models.layers.attention_merge2``): the prefix
with ``q_offset = S``, where the causal mask is vacuous and only the window
masks.

On the card the work is bound by operations (at the llama3_8b prefill
shape, about 500 FLOPs per byte moved), and only ``wgmma`` reaches the
card's bf16 tensor-core rate.  So bf16 inputs, the model's type, take a
Hopper kernel: a block serves the G query heads of one KV head together
(GQA-packed query tiles, so each K/V tile is staged once for all of them),
one producer warp feeds K and V tiles by TMA into a two-stage ring of
shared memory guarded by mbarriers, and consumer warpgroups run both
products on ``wgmma`` with the softmax of one tile overlapping the P·V of
the one before.  Only KV tiles that an edge crosses are masked
(:func:`tile_needs_mask`), and the query tiles that see the most keys start
first.  :func:`plan` fixes the tiles, the packing and the grid on the host.
fp32 inputs (training keeps the reference's fp32 arithmetic) run on the
tensor cores too, as 3xTF32 ``mma.sync``: each fp32 operand is split into a
TF32 part and the TF32 rest, and three TF32 products come close to fp32,
which holds the plain version's 2e-4 where one TF32 pass would not.  Each
warp owns 16 query rows of a 64-row tile, K and V tiles come through a
two-stage ``cp.async`` ring, and the scores stay in registers as P·V's
operand; :func:`f32_plan` fixes its tiles and grid.  The source is
``csrc/flash_attention.cu`` (the fragments: ``csrc/mma.cuh``).

:func:`flash_attention` launches a kernel on a CUDA tensor and raises on
what the kernels do not take; it never falls back to the plain version or
from one kernel to the other.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`;
:func:`repro_torch.kernels.ref.flash_attention_tiled` spells out the bf16
kernel's tiling and arithmetic in plain PyTorch, and
:func:`repro_torch.kernels.ref.flash_attention_tiled_f32` the fp32 kernel's,
with its products through :func:`repro_torch.kernels.ref.matmul_3xtf32`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

HEAD_DIMS = (32, 64, 128, 256)
# (query rows a block, keys a KV tile) the bf16 kernel is built for: 64 rows
# per consumer warpgroup; at 128 rows and 128 keys the consumers would spill.
# A tile is built for a head dim only where it fits SMEM_LIMIT (not 64 x 128
# at D = 256: 296,008 bytes)
TILES = ((64, 64), (64, 128), (128, 64))
STAGES = 2                  # K/V tiles in flight: kStages in the source
SMEM_LIMIT = 232448         # shared memory a block may have on the H100 (227 KB)
SMS = 132                   # streaming multiprocessors of the H100
_TMA_ALIGN = 16             # bytes: TMA's alignment of bases and strides

# keys a KV tile of the fp32 kernel at each head dim, the one tile built for
# it (launch_f32's instantiations in the source; scripts/time_fp32_tiles.py
# times the others): two blocks an SM up to D = 128, one at D = 256
F32_KEYS = {32: 64, 64: 64, 128: 32, 256: 32}
F32_ROWS = 64               # query rows an fp32 block: four warps of 16
F32_STAGES = 2              # K/V tiles in flight: kF32Stages

launches = 0        # kernel launches since the last reset (plain integer)


class FlashPlan(NamedTuple):
    """How the bf16 kernel covers one call (see :func:`plan`)."""
    block_rows: int      # query rows a block: (positions, packed head) pairs
    block_keys: int      # keys a KV tile
    pack: int            # query heads of one KV head packed into a tile
    positions: int       # query positions a tile: block_rows // pack
    groups: int          # packed head groups a KV head: G // pack
    q_tiles: int         # query tiles along T
    blocks: int          # the grid: q_tiles * groups * Hkv * B
    threads: int         # 128 per consumer warpgroup, plus a producer warpgroup
    smem_bytes: int      # dynamic shared memory a block


def pack_factor(G: int, block_rows: int) -> int:
    """The largest power of two that divides both G and the tile's rows:
    that many query heads of one KV head share a tile."""
    pack = 1
    while G % (2 * pack) == 0 and block_rows % (2 * pack) == 0:
        pack *= 2
    return pack


def smem_bytes(D: int, block_rows: int, block_keys: int) -> int:
    """Dynamic shared memory of the bf16 kernel (``Tile::kSmemBytes``): 1024
    bytes of alignment slack, the Q tile, the K and V rings, the mbarriers."""
    return (1024 + 2 * block_rows * D + 2 * STAGES * 2 * block_keys * D
            + 8 * (1 + 4 * STAGES))


@functools.lru_cache(maxsize=4096)
def plan(B: int, T: int, S: int, Hq: int, Hkv: int, D: int, *,
         block_rows: Optional[int] = None, block_keys: Optional[int] = None) -> FlashPlan:
    """The bf16 kernel's plan for one call, from plain integers (no device
    value is read, so the call can be captured in a CUDA graph).

    Default tiles, chosen by measurement on the H100 at the llama3_8b timed
    and serving shapes and at G = 8 (``scripts/time_flash_shapes.py``):
    128 query rows (two consumer warpgroups) when that grid still gives at
    least two thirds of the SMs a block, else 64; KV tiles of 64 keys, or of
    128 for 64-row tiles over 512 keys or more where they fit the shared
    memory (not at D = 256).  Tiles that do not fit ``SMEM_LIMIT`` raise."""
    G = Hq // Hkv
    if block_rows is None:
        wide = plan(B, T, S, Hq, Hkv, D, block_rows=128, block_keys=64).blocks
        block_rows = 128 if 3 * wide >= 2 * SMS else 64
    if block_keys is None:
        wide_keys = block_rows == 64 and S >= 512 and smem_bytes(D, 64, 128) <= SMEM_LIMIT
        block_keys = 128 if wide_keys else 64
    if (block_rows, block_keys) not in TILES:
        raise ValueError(f"flash_attention: tiles ({block_rows}, {block_keys}) not in {TILES}")
    if smem_bytes(D, block_rows, block_keys) > SMEM_LIMIT:
        raise ValueError(f"flash_attention: tiles ({block_rows}, {block_keys}) at D={D} need "
                         f"{smem_bytes(D, block_rows, block_keys)} bytes of shared memory, "
                         f"more than the {SMEM_LIMIT} a block may have")
    pack = pack_factor(G, block_rows)
    positions = block_rows // pack
    q_tiles = -(-T // positions)
    groups = G // pack
    return FlashPlan(block_rows, block_keys, pack, positions, groups, q_tiles,
                     q_tiles * groups * Hkv * B, 128 * (block_rows // 64 + 1),
                     smem_bytes(D, block_rows, block_keys))


class F32Plan(NamedTuple):
    """How the fp32 kernel covers one call (see :func:`f32_plan`)."""
    block_rows: int      # query rows a block (F32_ROWS)
    block_keys: int      # keys a KV tile (F32_KEYS[D])
    q_tiles: int         # query tiles along T
    blocks: int          # the grid: q_tiles * Hq * B
    threads: int         # four warps
    smem_bytes: int      # dynamic shared memory a block


def f32_smem_bytes(D: int, block_keys: int) -> int:
    """Dynamic shared memory of the fp32 kernel (``f32_smem_bytes`` in the
    source): the Q tile and the K and V rings, rows of D + 4 floats."""
    return (F32_ROWS + 2 * F32_STAGES * block_keys) * (D + 4) * 4


def f32_plan(B: int, T: int, S: int, Hq: int, Hkv: int, D: int) -> F32Plan:
    """The fp32 kernel's plan for one call, from plain integers: 64 query
    rows a block, ``F32_KEYS[D]`` keys a KV tile, one block per (query
    tile, query head, batch) in :func:`f32_block_coords`'s order."""
    if D not in F32_KEYS:
        raise ValueError(f"flash_attention: head_dim {D} not in {tuple(F32_KEYS)}")
    q_tiles = -(-T // F32_ROWS)
    return F32Plan(F32_ROWS, F32_KEYS[D], q_tiles, q_tiles * Hq * B, 128,
                   f32_smem_bytes(D, F32_KEYS[D]))


def f32_block_coords(p: F32Plan, B: int, Hq: int, index: int) -> Tuple[int, int, int]:
    """(batch, query head, query tile) of fp32 block ``index``, as the
    kernel decodes ``blockIdx.x``: query tiles from the last (the one that
    sees the most keys) to the first, within a tile the heads, then the
    batch."""
    per_tile = Hq * B
    rest = index % per_tile
    return rest // Hq, rest % Hq, p.q_tiles - 1 - index // per_tile


def block_coords(p: FlashPlan, B: int, Hkv: int, index: int) -> Tuple[int, int, int, int]:
    """(batch, KV head, packed head group, query tile) of block ``index``,
    as the kernel decodes ``blockIdx.x``: query tiles from the last (the one
    that sees the most keys) to the first, and within a tile the packed
    groups, then the KV heads, then the batch."""
    per_tile = p.groups * Hkv * B
    qt = p.q_tiles - 1 - index // per_tile
    rest = index % per_tile
    hg, rest = rest % p.groups, rest // p.groups
    return rest // Hkv, rest % Hkv, hg, qt


def kv_tile_range(q0: int, positions: int, T: int, S: int, block_keys: int,
                  causal: bool, window: Optional[int],
                  q_offset: Optional[int] = None) -> Tuple[int, int]:
    """[first, end) of the KV tiles that query rows q0 .. q0 + positions - 1
    (clipped to T; row t at key position ``q_offset + t``, ``S - T`` by
    default) can see, as the kernel walks them; empty when the window
    starts at or past S."""
    offset = S - T if q_offset is None else q_offset
    q_lo = q0 + offset
    q_hi = min(q0 + positions, T) - 1 + offset
    k_begin, k_end = 0, S
    if causal:
        k_end = min(S, q_hi + 1)
        if window is not None:
            k_begin = max(0, q_lo - window + 1)
    if k_begin >= k_end:
        return k_begin // block_keys, k_begin // block_keys
    return k_begin // block_keys, -(-k_end // block_keys)


def q_tile_range(k0: int, block_keys: int, T: int, S: int, block_q: int, causal: bool,
                 window: Optional[int], q_offset: Optional[int] = None) -> Tuple[int, int]:
    """[first, end) of the query tiles of ``block_q`` rows that see a key of
    the tile [k0, k0 + block_keys) (clipped to S): the inverse of
    :func:`kv_tile_range`, as the backward's dK/dV kernel walks them.  Query
    t sits at key position ``q_offset + t`` (``S - T`` by default) and sees
    key j when j <= it, and it - j < ``window``, under the causal mask."""
    offset = S - T if q_offset is None else q_offset
    k_last = min(k0 + block_keys, S) - 1
    t_lo, t_hi = 0, T - 1
    if causal:
        t_lo = max(0, k0 - offset)
        if window is not None:
            t_hi = min(t_hi, k_last + window - 1 - offset)
    if t_lo > t_hi:
        return t_lo // block_q, t_lo // block_q
    return t_lo // block_q, t_hi // block_q + 1


def tile_needs_mask(k0: int, block_keys: int, S: int, q_lo: int, q_hi: int,
                    causal: bool, window: Optional[int]) -> bool:
    """Whether KV tile [k0, k0 + block_keys) must be masked for query
    positions [q_lo, q_hi] (the query offset included): when S's end, the
    causal diagonal or the window's start crosses it.  The kernel's
    ``tile_needs_mask`` is the same predicate; other tiles skip the mask."""
    if k0 + block_keys > S:
        return True
    if not causal:
        return False
    if k0 + block_keys - 1 > q_lo:
        return True
    return window is not None and q_hi - k0 >= window


def tma_batch_stride(name: str, x: torch.Tensor) -> int:
    """The batch stride (elements) the kernels take for ``x``: the bf16
    kernel's TMA and the fp32 kernel's 16-byte ``cp.async`` copies need it to
    be a multiple of 16 bytes.  A batch of one has no
    stride to speak of, so it gets the dense one."""
    if x.shape[0] == 1:
        return math.prod(x.shape[1:])
    stride = x.stride(0)
    if stride <= 0 or (stride * x.element_size()) % _TMA_ALIGN:
        raise ValueError(f"flash_attention: the batch stride of {name} ({stride} elements) "
                         f"is not a positive multiple of {_TMA_ALIGN} bytes, which TMA and "
                         "cp.async need")
    return stride


@functools.cache
def _kernels():
    lib = _build.load("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    head = [p, p, p, p, i, i, i, i, i, i, ll, ll, ll, ll, ctypes.c_float, i, i, i, p]
    f32, bf16 = lib.flash_attention_fwd_f32, lib.flash_attention_fwd_bf16
    f32.argtypes = head + [i, p]
    bf16.argtypes = head + [i, i, i, p]
    f32.restype = bf16.restype = ctypes.c_int
    return f32, bf16


def _check_inner_dense(name: str, x: torch.Tensor) -> None:
    """Every dimension but the batch one must be dense (row-major)."""
    _, n, h, d = x.shape
    if x.stride(3) != 1 or x.stride(2) != d or x.stride(1) != h * d:
        raise ValueError(f"flash_attention: {name} must be dense past its batch "
                         f"dimension, got strides {tuple(x.stride())}")
    if x.data_ptr() % _TMA_ALIGN:
        raise ValueError(f"flash_attention: {name} must be {_TMA_ALIGN}-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softmax_scale: Optional[float] = None, q_offset: Optional[int] = None,
                    return_lse: bool = False):
    """q: (B, T, Hq, D); k, v: (B, S, Hkv, D) -> (B, T, Hq, D) in q's type,
    and with ``return_lse`` also the fp32 log-sum-exp of each row's scaled
    scores (B, T, Hq).  Query t sits at key position ``q_offset + t``
    (default S - T: the queries are the last T of the S keys).  A row that
    sees no key gives 0 and an lse of -inf.

    CUDA tensors only: fp32 or bf16, D in {32, 64, 128, 256}, Hq a multiple of
    Hkv, S >= T when causal without a ``q_offset``, ``q_offset`` >= 0; batch
    strides a multiple of 16 bytes.  Launches on the current stream
    without synchronising."""
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {x.device}; the "
                             "kernel takes CUDA tensors (the plain version is "
                             "repro_torch.kernels.ref.flash_attention_ref)")
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got {tuple(x.shape)}")
        if x.dtype != q.dtype or x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"flash_attention: q, k, v must share one type of "
                             f"float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
        _check_inner_dense(name, x)
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads over {Hkv} KV heads")
    if T < 1 or S < 1 or (causal and q_offset is None and S < T):
        raise ValueError(f"flash_attention: needs 1 <= T <= S when causal, "
                         f"got T={T}, S={S}")
    if q_offset is not None and not 0 <= q_offset < 2**31 - T:
        raise ValueError(f"flash_attention: q_offset {q_offset} must be >= 0")
    offset = S - T if q_offset is None else q_offset
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if B > 65535 or Hq > 65535:
        raise ValueError("flash_attention: batch and heads must be <= 65535")
    scale = softmax_scale or 1.0 / math.sqrt(D)
    win = window if (causal and window is not None) else 0
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, T, Hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lse_ptr = lse.data_ptr() if return_lse else None
    f32, bf16 = _kernels()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [tma_batch_stride(name, x) for name, x in (("q", q), ("k", k), ("v", v))]
    if q.dtype == torch.bfloat16:
        p = plan(B, T, S, Hq, Hkv, D)
        err = bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, T, S, Hq, Hkv, D, *strides, out.stride(0), scale, int(causal), win,
                   offset, lse_ptr, p.block_rows, p.block_keys, p.pack.bit_length() - 1, stream)
    else:
        p = f32_plan(B, T, S, Hq, Hkv, D)
        err = f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, T, S, Hq, Hkv, D, *strides, out.stride(0), scale, int(causal), win,
                  offset, lse_ptr, p.block_keys, stream)
    if err == 3000:
        raise RuntimeError("flash_attention: the driver has no cuTensorMapEncodeTiled")
    if err >= 1000:
        raise RuntimeError(f"flash_attention: the driver refused a TMA tensor map "
                           f"(CUresult {err - 1000})")
    if err:
        raise RuntimeError(f"flash_attention: launch failed with CUDA error {err}")
    launches += 1
    return (out, lse) if return_lse else out
