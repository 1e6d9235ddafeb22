"""Architecture registry: the 10 assigned architectures plus the paper's own
evaluation models (llama-3.1-8b, llama-3.1-70b, qwen3-30b-a3b).

Every module in this package exports ``CONFIG`` (the full published config)
and ``reduced()`` (a tiny same-family config for CPU smoke tests).  Select
with ``--arch <id>`` in the launchers.

The PyTorch port runs the dense decoders ``llama3_8b``, ``qwen2_5_3b`` and
``granite_8b`` and the SSM ``mamba2_370m``; ``get_config`` of any other
architecture raises ``NotImplementedError`` naming the ROADMAP item that
ports it.

Shape cells (assigned): each architecture is paired with all four shapes;
``decode_*``/``long_*`` lower ``serve_step`` (one token against a KV cache of
``seq_len``), ``prefill_32k`` lowers the chunked-prefill step, ``train_4k``
lowers ``train_step``.  ``long_500k`` requires sub-quadratic decode and is
skipped for pure full-attention architectures (see DESIGN.md
§Arch-applicability); the skip is explicit in :func:`applicable_shapes`.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List

from repro_torch.models.config import ModelConfig

__all__ = [
    "ShapeSpec",
    "SHAPES",
    "ARCH_IDS",
    "PAPER_ARCH_IDS",
    "get_config",
    "get_reduced_config",
    "applicable_shapes",
]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

ARCH_IDS: List[str] = [
    "qwen2_5_3b",
    "granite_3_8b",
    "granite_8b",
    "olmo_1b",
    "llava_next_mistral_7b",
    "dbrx_132b",
    "mixtral_8x7b",
    "recurrentgemma_2b",
    "whisper_base",
    "mamba2_370m",
]

# The paper's §6.1 evaluation models (used by the fidelity benchmarks).
PAPER_ARCH_IDS: List[str] = ["llama3_8b", "llama3_70b", "qwen3_30b_a3b"]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS + PAPER_ARCH_IDS}


# Architectures the port does not run yet -> the ROADMAP item that ports them.
_NOT_PORTED = {
    "granite_3_8b": "ROADMAP Queue A item 8 (sliding window and MoE)",
    "dbrx_132b": "ROADMAP Queue A item 8 (sliding window and MoE)",
    "mixtral_8x7b": "ROADMAP Queue A item 8 (sliding window and MoE)",
    "qwen3_30b_a3b": "ROADMAP Queue A item 8 (sliding window and MoE)",
    "olmo_1b": "ROADMAP Queue A item 8 (sliding window and MoE)",
    "llava_next_mistral_7b": "ROADMAP Queue A item 8 (sliding window and MoE)",
    "llama3_70b": "ROADMAP Queue A item 16 (tensor parallelism over four cards)",
    "recurrentgemma_2b": "ROADMAP Queue A item 11 (RG-LRU and mixed layer patterns)",
    "whisper_base": "ROADMAP Queue A item 12 (Whisper encoder-decoder)",
}


def _module(arch_id: str):
    arch_id = _ALIASES.get(arch_id, arch_id)
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} does not run in the PyTorch port yet: {_NOT_PORTED[arch_id]}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


def applicable_shapes(cfg: ModelConfig) -> List[ShapeSpec]:
    """The assigned shape cells this architecture participates in."""
    out = []
    for shape in SHAPES.values():
        if shape.name == "long_500k" and not cfg.supports_long_context():
            continue  # quadratic full attention — skip per assignment
        out.append(shape)
    return out

