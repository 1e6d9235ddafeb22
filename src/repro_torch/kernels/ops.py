"""Dispatch layer: the CUDA kernels on the card, the plain versions on the CPU.

Mirror of ``repro.kernels.ops``.  The model's attention and SSD blocks call
these: a CUDA tensor goes to the hand-written kernel, a CPU tensor to its
plain version in :mod:`repro_torch.kernels.ref`, and nothing falls back from
one to the other.
``force="plain"`` runs the plain version on the card, so that a check can hold
the kernel against it on the same inputs.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import flash_attention as _flash
from . import paged_attention as _paged
from . import ref
from . import ssd_scan as _ssd

_FORCES = (None, "plain")


def _use_kernel(x, force: Optional[str]) -> bool:
    if force not in _FORCES:
        raise ValueError(f"force must be one of {_FORCES}, got {force!r}")
    return force is None and x.device.type == "cuda"


def flash_attention(q, k, v, *, causal=True, window=None,
                    softmax_scale=None, force: Optional[str] = None):
    if _use_kernel(q, force):
        return _flash.flash_attention(
            q, k, v, causal=causal, window=window, softmax_scale=softmax_scale)
    return ref.flash_attention_ref(
        q, k, v, causal=causal, window=window, softmax_scale=softmax_scale)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    window=None, softmax_scale=None, force: Optional[str] = None):
    if _use_kernel(q, force):
        return _paged.paged_attention(
            q, k_pages, v_pages, block_tables, context_lens,
            window=window, softmax_scale=softmax_scale)
    return ref.paged_attention_ref(
        q, k_pages, v_pages, block_tables, context_lens,
        window=window, softmax_scale=softmax_scale)


def ssd_scan(xdt, dA, Bm, Cm, *, chunk: int = 128, initial_state=None,
             force: Optional[str] = None):
    if _use_kernel(xdt, force):
        return _ssd.ssd_scan(xdt, dA, Bm, Cm, chunk=chunk, initial_state=initial_state)
    return ref.ssd_scan_chunked(xdt, dA, Bm, Cm, chunk=chunk, initial_state=initial_state)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"flash_attention": _flash.launches,
            "paged_attention": _paged.launches,
            "ssd_scan": _ssd.launches}


def reset_launch_counts() -> None:
    _flash.launches = 0
    _paged.launches = 0
    _ssd.launches = 0
