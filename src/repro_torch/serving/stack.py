"""Stack factory: wire a serving engine in any of the three modes.

Choosing ``mode="emulate"`` swaps the model runner and attaches the
Timekeeper; every other component (scheduler, block manager, prefix cache,
benchmark runner) is reused bit for bit.  The emulated modes are those of
``repro.serving.stack.build_stack``: they touch no device and allocate no
tensor, so they run on a machine with no card.  ``mode="real"`` runs the
PyTorch model on ``device`` (``cuda`` unless it says otherwise).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.client import LocalTransport, TimeJumpClient
from repro_torch.core.clock import VirtualClock, WallSource
from repro_torch.core.device import resolve_device
from repro_torch.core.emulation import VirtualDeviceContext
from repro_torch.core.hardware import get_chip
from repro_torch.core.predictor import (AnalyticalPredictor, ParallelSpec,
                                        RuntimePredictor)
from repro_torch.core.timekeeper import Timekeeper
from repro_torch.models.config import ModelConfig

from .engine import LLMEngine
from .model_runner import (RealModelRunner, SleepModelRunner,
                           TimeWarpModelRunner)
from .scheduler import EngineConfig
from .workers import WorkerGroup


@dataclass
class ServingStack:
    engine: LLMEngine
    clock: VirtualClock
    transport: Optional[LocalTransport] = None
    timekeeper: Optional[Timekeeper] = None
    devices: Optional[VirtualDeviceContext] = None
    runner: object = None

    def shutdown(self) -> None:
        self.engine.stop()
        if self.timekeeper is not None:
            self.timekeeper.close()


def default_predictor(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                      *, overlap_collectives: bool = False) -> AnalyticalPredictor:
    return AnalyticalPredictor(
        model_cfg,
        ParallelSpec(tp=engine_cfg.tp, pp=engine_cfg.pp, ep=engine_cfg.ep),
        get_chip(engine_cfg.chip),
        overlap_collectives=overlap_collectives,
    )


def build_stack(
    model_cfg: ModelConfig,
    engine_cfg: EngineConfig,
    mode: str,
    *,
    predictor: Optional[RuntimePredictor] = None,
    model=None,
    params=None,
    max_seqs: Optional[int] = None,
    max_len: int = 512,
    jitter_cooldown: float = 0.0,
    use_worker_group: bool = True,
    wall: Optional[WallSource] = None,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    name: str = "engine",
) -> ServingStack:
    """``wall`` injects a deterministic wall source into the emulated modes
    (``ManualWallSource``: virtual time advances only through coordinated
    jumps, for exact, jitter-free timelines).  ``predictor`` defaults to the
    analytical model of ``engine_cfg.chip``.

    ``mode="real"``: the engine runs ``model`` with ``params`` on ``device``
    (``cuda`` unless it says otherwise), its slot cache in ``dtype``.  With
    prefix caching on, the runner gets the engine's block manager and keeps
    the KV of the cached blocks, ``num_blocks`` of them.  The runner is
    warmed up before the engine is returned."""
    if mode == "emulate":
        tk = Timekeeper(clock=VirtualClock(wall),
                        jitter_cooldown=jitter_cooldown)
        transport = LocalTransport(tk)
        clock = tk.clock
        pred = predictor or default_predictor(model_cfg, engine_cfg)
        chip = get_chip(engine_cfg.chip)
        n_dev = engine_cfg.tp * engine_cfg.pp
        devices = VirtualDeviceContext(n_dev, chip)
        kv_pool = int(
            engine_cfg.num_blocks * engine_cfg.block_size
            * model_cfg.kv_bytes_per_token())
        weights = model_cfg.param_count() * model_cfg.dtype_bytes
        if use_worker_group and n_dev > 1:
            workers = WorkerGroup(transport, n_dev, name=f"{name}-w")
            runner = TimeWarpModelRunner(
                pred, workers=workers, devices=devices,
                weight_bytes=weights, kv_pool_bytes=kv_pool)
        else:
            client = TimeJumpClient(transport, f"{name}-worker")
            runner = TimeWarpModelRunner(
                pred, client, devices=devices,
                weight_bytes=weights, kv_pool_bytes=kv_pool)
        engine = LLMEngine(engine_cfg, runner, clock, name=name)
        return ServingStack(engine, clock, transport, tk, devices, runner)

    if mode == "sleep":
        clock = VirtualClock(wall)
        pred = predictor or default_predictor(model_cfg, engine_cfg)
        runner = SleepModelRunner(pred, clock)
        engine = LLMEngine(engine_cfg, runner, clock, name=name)
        return ServingStack(engine, clock, runner=runner)

    if mode == "real":
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
        if engine_cfg.enable_prefix_caching:
            runner.attach_prefix_cache(engine.bm)
        return ServingStack(engine, clock, runner=runner)

    raise ValueError(f"unknown mode {mode!r}")
