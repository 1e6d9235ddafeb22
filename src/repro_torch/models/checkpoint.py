"""Checkpoints of the training state (parameters, optimizer, step metadata),
as ``repro.models.checkpoint``: a flat ``.npz`` keyed by each leaf's path,
with a JSON sidecar for scalars.

The keys are the reference's: ``params/`` and ``opt/`` followed by the path
of the leaf as ``repro.models.checkpoint._flatten`` spells it for the JAX
tree, dictionary keys and list indices joined by ``/`` and the optimizer
state's fields as ``.step``, ``.mu`` and ``.nu`` (``params/blocks/attn/wq``,
``opt/.step``, ``opt/.mu/blocks/attn/wq``).  So a checkpoint written by the
JAX package restores into the port, and one written here into the JAX
package.  A write goes to ``.tmp_step_*.npz`` and is then renamed over the
final name, so a crash mid-write never leaves a partial newest step.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .optim import AdamWState

PyTree = Any

_SAFE = re.compile(r"[^A-Za-z0-9_.]+")


def _paths(tree: PyTree, path: Tuple[str, ...] = ()):
    """(path, leaf) pairs of ``tree``, an ``AdamWState``'s fields spelt
    ``.step``, ``.mu``, ``.nu`` as JAX spells a named tuple's."""
    if isinstance(tree, AdamWState):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (str(i),))
    else:
        yield "/".join(_SAFE.sub("_", p) for p in path), tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:           # numpy has no bfloat16; widening is exact
        t = t.float()
    return t.cpu().numpy()


def save_checkpoint(ckpt_dir: str | Path, step: int, params: PyTree, opt_state: AdamWState,
                    *, extra: Optional[Dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}.npz"
    tmp = ckpt_dir / f".tmp_step_{step:08d}.npz"
    blobs = {f"{prefix}/{key}": _to_numpy(leaf)
             for prefix, tree in (("params", params), ("opt", opt_state))
             for key, leaf in _paths(tree)}
    with open(tmp, "wb") as f:
        np.savez(f, **blobs)
    meta = {"step": step, **(extra or {})}
    (ckpt_dir / f"step_{step:08d}.json").write_text(json.dumps(meta))
    os.replace(tmp, final)          # atomic publish
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The newest complete step in ``ckpt_dir`` (a partial write is still
    named ``.tmp_*``), or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.stem.split("_")[1]) for p in ckpt_dir.glob("step_*.npz")]
    return max(steps) if steps else None


def _rebuild(data, prefix: str, tree: PyTree, path: Tuple[str, ...] = ()) -> PyTree:
    if isinstance(tree, AdamWState):
        return AdamWState(*(_rebuild(data, prefix, getattr(tree, name), path + (f".{name}",))
                            for name in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(data, prefix, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(data, prefix, v, path + (str(i),)) for i, v in enumerate(tree)]
    key = f"{prefix}/" + "/".join(_SAFE.sub("_", p) for p in path)
    arr = data[key]
    if arr.shape != tuple(tree.shape):
        raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, the model's "
                         f"{tuple(tree.shape)}")
    return torch.from_numpy(np.asarray(arr, dtype=np.float32) if arr.dtype.name == "bfloat16"
                            else np.array(arr)).to(device=tree.device, dtype=tree.dtype)


def restore_checkpoint(ckpt_dir: str | Path, step: int, params_like: PyTree,
                       opt_like: AdamWState) -> Tuple[PyTree, AdamWState, Dict]:
    """Fresh tensors of the checkpoint at ``step``, in the structure, types
    and devices of the templates (params_like, opt_like); a leaf whose shape
    differs from its template's raises ``ValueError``.  Returns (params,
    opt_state, meta)."""
    ckpt_dir = Path(ckpt_dir)
    meta = json.loads((ckpt_dir / f"step_{step:08d}.json").read_text())
    with np.load(ckpt_dir / f"step_{step:08d}.npz") as data:
        return _rebuild(data, "params", params_like), _rebuild(data, "opt", opt_like), meta
