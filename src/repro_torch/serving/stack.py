"""Stack factory: wire a serving engine around the real-mode runner.

Mirror of ``repro.serving.stack.build_stack`` for ``mode="real"``; the
emulated modes (``"emulate"``, ``"sleep"``) come with the emulator slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.clock import VirtualClock
from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig

from .engine import LLMEngine
from .model_runner import RealModelRunner
from .scheduler import EngineConfig


@dataclass
class ServingStack:
    engine: LLMEngine
    clock: VirtualClock
    runner: object = None

    def shutdown(self) -> None:
        self.engine.stop()


def build_stack(
    model_cfg: ModelConfig,
    engine_cfg: EngineConfig,
    mode: str,
    *,
    model=None,
    params=None,
    max_seqs: Optional[int] = None,
    max_len: int = 512,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    name: str = "engine",
) -> ServingStack:
    """``mode="real"``: the engine runs ``model`` with ``params`` on
    ``device`` (``cuda`` unless it says otherwise), its slot cache in
    ``dtype``.  The runner is warmed up before the engine is returned."""
    if mode in ("emulate", "sleep"):
        raise NotImplementedError(
            f"mode={mode!r} does not run in the PyTorch port yet: ROADMAP Queue A "
            "item E (the emulate mode)")
    if mode != "real":
        raise ValueError(f"unknown mode {mode!r}")
    if model is None or params is None:
        raise ValueError("real mode needs a model and its params")
    device = resolve_device(device)
    clock = VirtualClock()
    runner = RealModelRunner(
        model, params,
        max_seqs=max_seqs or engine_cfg.max_num_seqs,
        max_len=max_len, clock=clock, device=device, dtype=dtype)
    runner.warmup(engine_cfg.max_batched_tokens)
    engine = LLMEngine(engine_cfg, runner, clock, name=name)
    return ServingStack(engine, clock, runner=runner)
