"""Dispatch layer: the CUDA kernels on the card, the plain versions on the CPU.

Mirror of ``repro.kernels.ops``.  The model's attention and SSD blocks call
these: a CUDA tensor goes to the hand-written kernel, a CPU tensor to its
plain version in :mod:`repro_torch.kernels.ref`, and nothing falls back from
one to the other.
``force="plain"`` runs the plain version on the card, so that a check can hold
the kernel against it on the same inputs.

Training differentiates through the same dispatch.  On the card, a call of
:func:`flash_attention` whose q, k or v needs a gradient runs K1 through a
``torch.autograd.Function`` whose backward is K1's gradient kernel
(``kernels/flash_attention_bwd.py``), and a call of :func:`ssd_scan` whose
xdt, dA, Bm, Cm or initial state needs one runs K3 through another whose
backward is K3's gradient kernel (``kernels/ssd_scan_bwd.py``); the plain
versions (the CPU, and ``force="plain"``) are differentiated by autograd.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import flash_attention as _flash
from . import flash_attention_bwd as _flash_bwd
from . import paged_attention as _paged
from . import ref
from . import ssd_scan as _ssd
from . import ssd_scan_bwd as _ssd_bwd

_FORCES = (None, "plain")


def _use_kernel(x, force: Optional[str]) -> bool:
    if force not in _FORCES:
        raise ValueError(f"force must be one of {_FORCES}, got {force!r}")
    return force is None and x.device.type == "cuda"


class _FlashAttention(torch.autograd.Function):
    """K1 forward (with its lse) and K1's gradient kernel backward, on CUDA
    tensors.  Returns (out, lse); the lse carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softmax_scale, q_offset):
        kw = dict(causal=causal, window=window, softmax_scale=softmax_scale, q_offset=q_offset)
        out, lse = _flash.flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        if dout is None:
            return (None,) * 7
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd.flash_attention_bwd(
            q.contiguous(), k.contiguous(), v.contiguous(), out, dout.contiguous(), lse,
            **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, softmax_scale=None,
                    q_offset=None, return_lse=False, force: Optional[str] = None):
    kw = dict(causal=causal, window=window, softmax_scale=softmax_scale,
              q_offset=q_offset, return_lse=return_lse)
    if _use_kernel(q, force):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            out, lse = _FlashAttention.apply(q, k, v, causal, window, softmax_scale, q_offset)
            return (out, lse) if return_lse else out
        return _flash.flash_attention(q, k, v, **kw)
    return ref.flash_attention_ref(q, k, v, **kw)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    window=None, softmax_scale=None, return_lse=False,
                    force: Optional[str] = None):
    kw = dict(window=window, softmax_scale=softmax_scale, return_lse=return_lse)
    if _use_kernel(q, force):
        return _paged.paged_attention(q, k_pages, v_pages, block_tables, context_lens, **kw)
    return ref.paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens, **kw)


class _SsdScan(torch.autograd.Function):
    """K3 forward (keeping its chunk states) and K3's gradient kernel
    backward, on CUDA tensors.  Returns (y, final state)."""

    @staticmethod
    def forward(ctx, xdt, dA, Bm, Cm, initial_state, chunk):
        y, state, carry = _ssd.ssd_scan(xdt, dA, Bm, Cm, chunk=chunk,
                                        initial_state=initial_state)
        ctx.save_for_backward(xdt, dA, Bm, Cm, initial_state, carry, state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_state):
        if dy is None and d_state is None:
            return (None,) * 6
        xdt, dA, Bm, Cm, initial_state, carry, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(xdt.shape, dtype=torch.float32, device=xdt.device)
        grads = _ssd_bwd.ssd_scan_bwd(
            xdt, dA, Bm, Cm, dy.float().contiguous(), carry, state, chunk=ctx.chunk,
            initial_state=initial_state,
            d_final=None if d_state is None else d_state.float().contiguous())
        inputs = (xdt, dA, Bm, Cm, initial_state)
        return tuple(None if g is None else g.to(x.dtype) for g, x in zip(grads, inputs)) + (None,)


def ssd_scan(xdt, dA, Bm, Cm, *, chunk: int = 128, initial_state=None,
             force: Optional[str] = None):
    if _use_kernel(xdt, force):
        if torch.is_grad_enabled() and any(
                x is not None and x.requires_grad for x in (xdt, dA, Bm, Cm, initial_state)):
            return _SsdScan.apply(xdt, dA, Bm, Cm, initial_state, chunk)
        return _ssd.ssd_scan(xdt, dA, Bm, Cm, chunk=chunk, initial_state=initial_state)[:2]
    return ref.ssd_scan_chunked(xdt, dA, Bm, Cm, chunk=chunk, initial_state=initial_state)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts` (a
    gradient kernel: one per call, whatever the launches it makes)."""
    return {"flash_attention": _flash.launches,
            "flash_attention_bwd": _flash_bwd.launches,
            "paged_attention": _paged.launches,
            "ssd_scan": _ssd.launches,
            "ssd_scan_bwd": _ssd_bwd.launches}


def reset_launch_counts() -> None:
    _flash.launches = 0
    _flash_bwd.launches = 0
    _paged.launches = 0
    _ssd.launches = 0
    _ssd_bwd.launches = 0
