"""Carry a JAX parameter tree into the port.

The JAX package's ``TransformerLM.init`` gives a nested dictionary whose
leaves are arrays; passed through ``numpy.asarray`` it becomes the input of
:func:`from_numpy`.  The port keeps the JAX names, layouts and the stacked
(L, ...) block leaves, so the conversion is a copy keyed by the JAX path,
with no renaming and no transposes.  Random initialisations cannot match
across frameworks; this is how both packages get the same weights.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device

from .layers import FP32_LEAVES


def _leaf(arr, device, dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: go by fp32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))    # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _convert(tree: Any, device, dtype, name: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    return _leaf(tree, device, None if name in FP32_LEAVES else dtype)


def from_numpy(tree: Any, *, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """Same structure, numpy leaves -> tensors on ``device`` (``cuda`` unless
    it says otherwise); ``dtype`` recasts floating leaves, except those the
    reference keeps in fp32 whatever the model's type (``FP32_LEAVES``)."""
    return _convert(tree, resolve_device(device), dtype)
