"""Fleet specs: N model pools + M tenants over one declarative scenario.

A :class:`FleetSpec` extends a :class:`~repro.scenario.Scenario` (its
``fleet`` field) into a multi-model, multi-tenant serving plane:

* ``models`` — one :class:`ModelPoolSpec` per served model: a full
  :class:`~repro.scenario.PoolSpec` (model config, engine knobs, tiers,
  predictor), its own routing policy and optional per-pool autoscaler, and
  optionally a set of LoRA :class:`AdapterSpec` entries multiplexed onto the
  shared base-model replicas;
* ``tenants`` — one :class:`TenantSpec` per traffic source: a weighted share
  of the scenario's open-loop stream, a priority for ingress tie-breaking, a
  per-tenant :class:`~repro.scenario.SLOSpec`, and the target model (or
  model + adapter) its requests are served by.

The specs reuse the scenario codec (`to_dict`/`from_dict` with dotted-path
``SpecError``\\ s), so a fleet is just more JSON in the same scenario file,
and list-valued fields report errors with indexed paths
(``fleet.tenants[1].slo.ttft_s``).

Capacity semantics: each adapter's ``kv_blocks`` is debited from its base
pool's ``num_blocks`` (resident adapter weights/KV eat into shared HBM), and
``swap_s`` models the one-time adapter cold-load as a virtual-time stall the
first request of that adapter pays — spec-level arithmetic, identical on
every backend, so fleet runs stay parity-comparable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.scenario.spec import (AutoscaleSpec, PoolSpec, RoutingSpec,
                                 SLOSpec, SpecError, _SpecBase)

__all__ = [
    "AdapterSpec",
    "ModelPoolSpec",
    "TenantSpec",
    "FleetSpec",
]


@dataclass(frozen=True)
class AdapterSpec(_SpecBase):
    """One LoRA adapter multiplexed onto a shared base-model pool.

    ``kv_blocks`` is the KV/weight overhead of keeping the adapter resident,
    debited from the base pool's ``num_blocks``; ``swap_s`` is the one-time
    cold-load latency the adapter's first request pays (a virtual-time
    stall — the ingress shifts service start past it and re-adds it to that
    request's reported TTFT/e2e).
    """

    name: str = "adapter"
    kv_blocks: int = 0
    swap_s: float = 0.0

    def validate(self, *, path: str = "adapter") -> None:
        if not self.name:
            raise SpecError(f"{path}.name: must be non-empty")
        if self.kv_blocks < 0:
            raise SpecError(f"{path}.kv_blocks: must be >= 0")
        if self.swap_s < 0:
            raise SpecError(f"{path}.swap_s: must be >= 0")


@dataclass(frozen=True)
class ModelPoolSpec(_SpecBase):
    """One served model: a replica pool plus its routing/scaling/adapters."""

    name: str = "model"
    pool: PoolSpec = field(default_factory=PoolSpec)
    routing: RoutingSpec = field(default_factory=RoutingSpec)
    autoscale: Optional[AutoscaleSpec] = None
    adapters: Tuple[AdapterSpec, ...] = ()

    def validate(self, *, path: str = "model") -> None:
        if not self.name:
            raise SpecError(f"{path}.name: must be non-empty")
        self.pool.validate(path=f"{path}.pool")
        self.routing.validate(path=f"{path}.routing")
        if self.routing.policy == "pd_pool":
            raise SpecError(f"{path}.routing.policy: pd_pool is not "
                            "supported inside a fleet pool")
        seen = set()
        for i, a in enumerate(self.adapters):
            a.validate(path=f"{path}.adapters[{i}]")
            if a.name in seen:
                raise SpecError(f"{path}.adapters[{i}].name: duplicate "
                                f"adapter name {a.name!r}")
            seen.add(a.name)
        overhead = sum(a.kv_blocks for a in self.adapters)
        if overhead >= self.pool.num_blocks:
            raise SpecError(
                f"{path}.adapters: resident adapter overhead "
                f"({overhead} blocks) consumes the whole pool "
                f"(pool.num_blocks={self.pool.num_blocks})")
        if self.autoscale is not None:
            self.autoscale.validate(path=f"{path}.autoscale")
            a = self.autoscale
            if not (a.min_replicas <= self.pool.replicas <= a.max_replicas):
                raise SpecError(
                    f"{path}.pool.replicas: initial pool "
                    f"({self.pool.replicas}) outside autoscale bounds "
                    f"[{a.min_replicas}, {a.max_replicas}]")

    def adapter(self, name: str) -> AdapterSpec:
        for a in self.adapters:
            if a.name == name:
                return a
        raise KeyError(name)

    def effective_pool(self) -> PoolSpec:
        """The pool with resident-adapter KV overhead debited from its
        block budget — what the engines are actually built with."""
        overhead = sum(a.kv_blocks for a in self.adapters)
        if overhead == 0:
            return self.pool
        return dataclasses.replace(
            self.pool, num_blocks=self.pool.num_blocks - overhead)


@dataclass(frozen=True)
class TenantSpec(_SpecBase):
    """One traffic source: a weighted slice of the scenario's workload.

    ``share`` is a relative weight (shares need not sum to anything);
    ``priority`` breaks ingress assignment ties (higher first).  ``model``
    names the target :class:`ModelPoolSpec`; ``adapter`` (optional) names a
    LoRA adapter declared on that model.  ``slo`` judges this tenant's
    attainment — per-tenant SLOs are the whole point of the fleet plane.
    """

    name: str = "tenant"
    share: float = 1.0
    priority: int = 0
    model: str = "model"
    adapter: Optional[str] = None
    slo: SLOSpec = field(default_factory=SLOSpec)

    def validate(self, *, path: str = "tenant") -> None:
        if not self.name:
            raise SpecError(f"{path}.name: must be non-empty")
        if self.share <= 0:
            raise SpecError(f"{path}.share: must be > 0")
        self.slo.validate(path=f"{path}.slo")


@dataclass(frozen=True)
class FleetSpec(_SpecBase):
    """The whole plane: model pools + tenants (see module docstring)."""

    models: Tuple[ModelPoolSpec, ...] = ()
    tenants: Tuple[TenantSpec, ...] = ()

    def validate(self, *, path: str = "fleet") -> None:
        if not self.models:
            raise SpecError(f"{path}.models: need at least one model pool")
        if not self.tenants:
            raise SpecError(f"{path}.tenants: need at least one tenant")
        by_name = {}
        for i, m in enumerate(self.models):
            m.validate(path=f"{path}.models[{i}]")
            if m.name in by_name:
                raise SpecError(f"{path}.models[{i}].name: duplicate model "
                                f"name {m.name!r}")
            by_name[m.name] = m
        seen = set()
        for i, t in enumerate(self.tenants):
            t.validate(path=f"{path}.tenants[{i}]")
            if t.name in seen:
                raise SpecError(f"{path}.tenants[{i}].name: duplicate "
                                f"tenant name {t.name!r}")
            seen.add(t.name)
            target = by_name.get(t.model)
            if target is None:
                raise SpecError(
                    f"{path}.tenants[{i}].model: unknown model {t.model!r} "
                    f"(declared: {', '.join(sorted(by_name))})")
            if t.adapter is not None:
                valid = [a.name for a in target.adapters]
                if t.adapter not in valid:
                    raise SpecError(
                        f"{path}.tenants[{i}].adapter: model {t.model!r} "
                        f"declares no adapter {t.adapter!r} "
                        f"(declared: {', '.join(sorted(valid)) or 'none'})")

    def model(self, name: str) -> ModelPoolSpec:
        for m in self.models:
            if m.name == name:
                return m
        raise KeyError(name)

    def tenant(self, name: str) -> TenantSpec:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)
