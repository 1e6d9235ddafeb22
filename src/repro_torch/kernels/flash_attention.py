"""Flash attention for prefill and chunked prefill: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_kernel``): causal GQA attention whose queries are the last T of S
keys, with an optional sliding window, fp32 running max/sum/accumulator and
a default scale of 1/sqrt(D).

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
fp32 inputs run on the CUDA cores in fp32, to match the plain version to
2e-4.  The source is ``csrc/flash_attention.cu``.

:func:`flash_attention` launches a kernel on a CUDA tensor and raises on
what the kernels do not take; it never falls back to the plain version or
from one kernel to the other.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`, and
:func:`repro_torch.kernels.ref.flash_attention_tiled` spells out the bf16
kernel's tiling and arithmetic in plain PyTorch.
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
                  causal: bool, window: Optional[int]) -> Tuple[int, int]:
    """[first, end) of the KV tiles that query positions q0 .. q0 +
    positions - 1 (clipped to T) can see, as the kernel walks them."""
    offset = S - T
    q_lo = q0 + offset
    q_hi = min(q0 + positions, T) - 1 + offset
    k_begin, k_end = 0, S
    if causal:
        k_end = min(S, q_hi + 1)
        if window is not None:
            k_begin = max(0, q_lo - window + 1)
    return k_begin // block_keys, -(-k_end // block_keys)


def tile_needs_mask(k0: int, block_keys: int, S: int, q_lo: int, q_hi: int,
                    causal: bool, window: Optional[int]) -> bool:
    """Whether KV tile [k0, k0 + block_keys) must be masked for query
    positions [q_lo, q_hi] (the offset S - T included): when S's end, the
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
    """The batch stride (elements) the bf16 kernel's tensor map takes for
    ``x``: TMA needs it to be a multiple of 16 bytes.  A batch of one has no
    stride to speak of, so it gets the dense one."""
    if x.shape[0] == 1:
        return math.prod(x.shape[1:])
    stride = x.stride(0)
    if stride <= 0 or (stride * x.element_size()) % _TMA_ALIGN:
        raise ValueError(f"flash_attention: the batch stride of {name} ({stride} elements) "
                         f"is not a positive multiple of {_TMA_ALIGN} bytes, which TMA needs")
    return stride


@functools.cache
def _kernels():
    lib = _build.load("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    head = [p, p, p, p, i, i, i, i, i, i, ll, ll, ll, ll, ctypes.c_float, i, i]
    f32, bf16 = lib.flash_attention_fwd_f32, lib.flash_attention_fwd_bf16
    f32.argtypes = head + [p]
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
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, T, Hq, D); k, v: (B, S, Hkv, D) -> (B, T, Hq, D) in q's type.

    CUDA tensors only: fp32 or bf16, D in {32, 64, 128, 256}, Hq a multiple of
    Hkv, S >= T when causal; bf16 batch strides a multiple of 16 bytes.
    Launches on the current stream without synchronising."""
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
    if T < 1 or S < 1 or (causal and S < T):
        raise ValueError(f"flash_attention: needs 1 <= T <= S when causal, "
                         f"got T={T}, S={S}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if B > 65535 or Hq > 65535:
        raise ValueError("flash_attention: batch and heads must be <= 65535")
    scale = softmax_scale or 1.0 / math.sqrt(D)
    win = window if (causal and window is not None) else 0
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    f32, bf16 = _kernels()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        strides = [tma_batch_stride(name, x) for name, x in (("q", q), ("k", k), ("v", v))]
        p = plan(B, T, S, Hq, Hkv, D)
        err = bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, T, S, Hq, Hkv, D, *strides, out.stride(0), scale, int(causal), win,
                   p.block_rows, p.block_keys, p.pack.bit_length() - 1, stream)
    else:
        err = f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, T, S, Hq, Hkv, D, q.stride(0), k.stride(0), v.stride(0),
                  out.stride(0), scale, int(causal), win, stream)
    if err == 3000:
        raise RuntimeError("flash_attention: the driver has no cuTensorMapEncodeTiled")
    if err >= 1000:
        raise RuntimeError(f"flash_attention: the driver refused a TMA tensor map "
                           f"(CUresult {err - 1000})")
    if err:
        raise RuntimeError(f"flash_attention: launch failed with CUDA error {err}")
    launches += 1
    return out
