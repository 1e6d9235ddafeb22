"""The gradient of K3, the Mamba2 chunked SSD scan: the CUDA kernel's wrapper.

The JAX package trains its SSD layers through the jnp chunked scan
(``repro.models.layers.ssd_chunked_ref``), which XLA differentiates; its
Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan`` has no gradient.  The
port trains through K3 (:mod:`repro_torch.kernels.ssd_scan`), so K3 gets a
gradient of its own, ``csrc/ssd_scan_bwd.cu``, in four launches: C·Bᵀ once
per chunk and each (chunk, head)'s own share of the state gradient; the
reverse scan of the state gradient from the last chunk to the first; per
(chunk, head) the gradients of xdt, dA and the head's partials of B and C;
and the partials summed over the heads in a fixed order (no atomics, the
same bits every run).  The states around each chunk are the ones K3's
forward computed (the ``carry`` that ``ssd_scan`` returns), kept rather than
recomputed: at mamba2_370m's training shape (a microbatch of 4 sequences of
2048 tokens) they are 67 MB a layer call, and under remat only the layer
being differentiated holds them.  fp32 on the CUDA cores; fp32 or bf16 in,
fp32 gradients out.

:func:`ssd_scan_bwd` launches on CUDA tensors and raises on what the kernel
does not take; it never falls back to the plain version.  The plain version
is autograd through :func:`repro_torch.kernels.ref.ssd_scan_chunked`, and
:func:`repro_torch.kernels.ref.ssd_scan_bwd_two_pass` spells out the
kernel's passes in plain PyTorch.  ``repro_torch.kernels.ops`` binds K3 and
this gradient into one ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from .ssd_scan import _DTYPES, COL_TILE, MAX_CHUNK, MAX_STATE, ROW_BLOCK, n_chunks

launches = 0        # wrapper calls that launched the gradient's kernels (one gradient each)


def scratch_shapes(B: int, T: int, H: int, P: int, N: int, chunk: int):
    """Shapes of the fp32 scratch: C·Bᵀ of each chunk, the state gradient
    (each chunk's own share, then the gradient leaving it), each chunk's
    decay, and the heads' partials of dB and dC."""
    nc = n_chunks(T, chunk)
    return ((B, nc, chunk, chunk), (B, nc, H, N, P), (B, nc, H), (B, nc, H, chunk, N),
            (B, nc, H, chunk, N))


@functools.cache
def _kernel():
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 19 + [i] * 6 + [ll] * 10 + [i, p]
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
    nc = n_chunks(T, chunk)
    if B > 65535 or H > 65535 or nc > 65535:
        raise ValueError("ssd_scan_bwd: batch, heads and chunks must be <= 65535")
    _dense_state("dy", dy, (B, T, H, P))
    _dense_state("carry", carry, (B, nc, H, N, P))
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
    # the scratch in one fp32 allocation: CB, G, decay, dB's and dC's
    # partials; each part starts 16 bytes aligned
    sizes = [-(-math.prod(shape) // 4) * 4 for shape in scratch_shapes(B, T, H, P, N, chunk)]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    cb_ptr, g_ptr, decay_ptr, dbp_ptr, dcp_ptr = (
        scratch.data_ptr() + 4 * sum(sizes[:k]) for k in range(5))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
        carry.data_ptr(), None if initial_state is None else initial_state.data_ptr(),
        final_state.data_ptr(), None if d_final is None else d_final.data_ptr(),
        cb_ptr, g_ptr, decay_ptr, dbp_ptr, dcp_ptr, dx.data_ptr(), ddA.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), None if d_init is None else d_init.data_ptr(),
        B, T, H, P, N, chunk,
        xdt.stride(0), xdt.stride(1), xdt.stride(2), dA.stride(0), dA.stride(1), dA.stride(2),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
        _DTYPES[xdt.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd: launch failed with CUDA error {err}")
    launches += 1
    return dx, ddA, dB, dC, d_init
