"""Device selection for the port's entry points.

Every entry point runs on the card unless its caller names the CPU: a missing
card is an error, never a silent fall back to the CPU.  The module imports
``torch`` only when a device is resolved, so that the emulated stack, which
imports it and resolves none, runs without torch.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
