"""Prefill/decode disaggregation (DistServe/Splitwise-style) under emulation.

Two engines share one Timekeeper: a *prefill engine* that admits fresh
requests and a *decode engine* that continues them.  On prefill completion
the request's KV cache "migrates" over an :class:`EmulatedChannel` — no data
moves, but the transfer occupies virtual time (bytes / link bandwidth) and
the decode engine cannot act on the request before its virtual arrival
(§4.3 "Preserving Distributed Dependencies").

Since the multi-replica refactor this module is a thin compatibility facade:
the handoff machinery (KV channel, mover actors, causal registration) lives
in :class:`repro.cluster.Cluster` under its ``pd_pool`` routing policy, and
:class:`DisaggregatedCluster` is exactly that cluster with one prefill and
one decode replica.  The Table-1 claim is unchanged — the disaggregation
logic is real orchestration code built on unmodified ``LLMEngine``s, not a
simulator approximation — and now the same code path scales to arbitrary
prefill/decode pool sizes via ``build_cluster(..., policy="pd_pool")``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.models.config import ModelConfig

from .engine import LLMEngine
from .request import Request


@dataclass
class DisaggConfig:
    kv_link_bandwidth: float = 50e9      # inter-engine KV fabric (bytes/s)


class DisaggregatedCluster:
    """Router + prefill engine + decode engine + KV-transfer channel.

    Facade over ``repro.cluster.Cluster`` with a 2-replica ``pd_pool``
    router (replica 0 = prefill, replica 1 = decode)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        prefill_engine: LLMEngine,
        decode_engine: LLMEngine,
        cfg: DisaggConfig = DisaggConfig(),
        transport=None,
    ):
        from repro_torch.cluster import Cluster, ClusterConfig, PDPoolRouter

        self.model_cfg = model_cfg
        self.prefill_engine = prefill_engine
        self.decode_engine = decode_engine
        self.cfg = cfg
        self._cluster = Cluster(
            [prefill_engine, decode_engine],
            PDPoolRouter(2, num_prefill=1),
            transport=transport,
            model_cfg=model_cfg,
            cfg=ClusterConfig(kv_link_bandwidth=cfg.kv_link_bandwidth),
        )
        self.channel = self._cluster.channel
        self.clock = self._cluster.clock

    # ------------------------------------------------------------- intake --
    def submit(self, req: Request) -> None:
        self._cluster.submit(req)

    def start(self) -> None:
        self._cluster.start()

    def stop(self) -> None:
        self._cluster.stop()

    @property
    def is_running(self) -> bool:
        return self._cluster.is_running

    # ------------------------------------------------------------ waiting --
    def wait_until_complete(self, expected: int, timeout: float = 600.0) -> bool:
        return self._cluster.wait_until_complete(expected, timeout=timeout)

    @property
    def finished(self) -> List[Request]:
        return self._cluster.finished

    @property
    def step_log(self):
        return self._cluster.step_log

    @property
    def engines(self):
        return self._cluster.engines

    @property
    def router(self):
        return self._cluster.router
