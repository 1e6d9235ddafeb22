"""Flash attention for prefill and chunked prefill: the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_kernel``): causal GQA attention whose queries are the last T of S
keys, with an optional sliding window, fp32 running max/sum/accumulator and
a default scale of 1/sqrt(D).

On the card the work is bound by operations (at the llama3_8b prefill
shape, about 500 FLOPs per byte moved), so the kernel keeps each query tile
and its fp32 accumulator on chip for the whole KV walk, stages each KV tile
once per block and skips whole tiles past the causal edge or before the
window.  bf16 inputs, the model's type, run both products on the tensor
cores (``mma.sync``, scores kept in registers as the A operand of P @ V);
fp32 inputs run on the CUDA cores in fp32, to match the plain version to
2e-4.  Neither stage is pipelined yet (no ``cp.async``/TMA, no ``wgmma``).
The source is ``csrc/flash_attention.cu``.

:func:`flash_attention` launches the kernel on a CUDA tensor and raises on
what the kernel does not take; it never falls back to the plain version.
The plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0        # kernel launches since the last reset (plain integer)


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").flash_attention_fwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ll, ll, ll, ll,
                   ctypes.c_float, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_inner_dense(name: str, x: torch.Tensor) -> None:
    """Every dimension but the batch one must be dense (row-major)."""
    _, n, h, d = x.shape
    if x.stride(3) != 1 or x.stride(2) != d or x.stride(1) != h * d:
        raise ValueError(f"flash_attention: {name} must be dense past its batch "
                         f"dimension, got strides {tuple(x.stride())}")
    if x.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, T, Hq, D); k, v: (B, S, Hkv, D) -> (B, T, Hq, D) in q's type.

    CUDA tensors only: fp32 or bf16, D in {32, 64, 128}, Hq a multiple of
    Hkv, S >= T when causal.  Launches on the current stream without
    synchronising."""
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {x.device}; the "
                             "kernel takes CUDA tensors (the plain version is "
                             "repro_torch.kernels.ref.flash_attention_ref)")
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got {tuple(x.shape)}")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise ValueError(f"flash_attention: q, k, v must share one type of "
                             f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
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
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, T, S, Hq, Hkv, D, q.stride(0), k.stride(0), v.stride(0),
             out.stride(0), scale, int(causal),
             window if (causal and window is not None) else 0,
             _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention: launch failed with CUDA error {err}")
    launches += 1
    return out
