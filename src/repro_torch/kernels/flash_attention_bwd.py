"""The gradient of K1: the CUDA kernel's wrapper.

The JAX package trains through its dense attention, which XLA
differentiates; it has no backward kernel.  The port trains through K1
(:mod:`repro_torch.kernels.flash_attention`), so K1 gets a gradient of its
own, ``csrc/flash_attention_bwd.cu``: from q, k, v, K1's output and its
fp32 log-sum-exp, three launches compute delta = rowsum(dO ∘ O), then dK
and dV (one block per key tile and KV head, summing the G query heads of its
group, so no atomics), then dQ (one block per query tile and head).  The
masks are K1's: causal with query t at key position ``q_offset + t`` (S − T
by default) and an optional window, or none.  fp32 products and sums on the
CUDA cores, fp32 or bf16 in and out.

:func:`flash_attention_bwd` launches on CUDA tensors and raises on what the
kernel does not take; it never falls back to the plain version.  The plain
version is autograd through :func:`repro_torch.kernels.ref.flash_attention_ref`,
and :func:`repro_torch.kernels.ref.flash_attention_bwd_tiled` spells out the
kernel's tiles and loop order in plain PyTorch.  ``repro_torch.kernels.ops``
binds the two directions into one ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from .flash_attention import HEAD_DIMS

BLOCK_Q = 64        # query rows a tile: kBlockQ in the source
BLOCK_K = 32        # keys a tile: kBlockK
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0        # wrapper calls that launched the three kernels (one gradient each)


@functools.cache
def _kernel():
    lib = _build.load("flash_attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.flash_attention_bwd
    fn.argtypes = [i] + [p] * 10 + [i] * 6 + [ctypes.c_float, i, i, i, p]
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
    offset = S - T if q_offset is None else q_offset
    scale = softmax_scale or 1.0 / math.sqrt(D)
    win = window if (causal and window is not None) else 0
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, T, Hq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), B, T, S, Hq, Hkv, D, scale, int(causal), win,
                    offset, stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd: launch failed with CUDA error {err}")
    launches += 1
    return dq, dk, dv
