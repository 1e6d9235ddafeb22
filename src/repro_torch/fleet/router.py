"""The ingress: deterministic tenant assignment + per-model demultiplexing.

:class:`ModelRouter` sits *above* the per-pool request routers: it walks the
scenario's open-loop request stream in arrival order, assigns each request
to a tenant by smooth weighted round-robin over the tenants' traffic shares
(deterministic — no RNG, so every backend sees the identical split), tags
the request with its tenant and LoRA adapter, and buckets it into its target
model pool's stream.  Adapter cold-loads are applied here as virtual-time
stalls: the first request of each adapter has its service start shifted past
``swap_s`` (the engine's dispatcher literally jumps the virtual clock over
the swap) and the shift is recorded so the fleet aggregation re-adds it to
that request's *reported* TTFT/e2e — the tenant pays for the swap, the
parity arithmetic stays backend-identical.

Smooth WRR: per step every tenant's credit grows by its share; the richest
tenant (ties: higher ``priority``, then spec order) takes the request and
pays the total share back.  For shares 2:1:1 the emitted sequence is
A B C A · A B C A · … — the classic interleaved schedule, a function of the
spec alone, independent of request contents.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from repro_torch.fleet.spec import FleetSpec

__all__ = ["ModelRouter", "FleetAssignment"]


@dataclass
class FleetAssignment:
    """What the ingress produced for one run (all maps keyed stably)."""

    # model pool name -> its arrival-ordered, tenant-tagged request stream
    pools: Dict[str, List] = field(default_factory=dict)
    # ingress audit: tenant name per request, arrival order (deterministic
    # function of the spec — identical on every backend by construction)
    ingress: List[str] = field(default_factory=list)
    # request_id -> virtual seconds of adapter cold-load the request's
    # service start was shifted past (re-added to reported TTFT/e2e)
    swap_shift: Dict[int, float] = field(default_factory=dict)
    # tenant name -> number of requests assigned (submitted)
    submitted: Dict[str, int] = field(default_factory=dict)


class ModelRouter:
    """Deterministic multi-model ingress (see module docstring)."""

    def __init__(self, fleet: FleetSpec):
        self.fleet = fleet
        self._tenants = list(fleet.tenants)
        self._total_share = sum(t.share for t in self._tenants)
        # smooth-WRR credit per tenant, spec order
        self._credit = [0.0] * len(self._tenants)

    def _next_tenant(self) -> int:
        """One smooth-WRR step; returns the chosen tenant's spec index."""
        for i, t in enumerate(self._tenants):
            self._credit[i] += t.share
        best = min(
            range(len(self._tenants)),
            key=lambda i: (-self._credit[i], -self._tenants[i].priority, i))
        self._credit[best] -= self._total_share
        return best

    def assign(self, requests: Sequence) -> FleetAssignment:
        """Split an arrival-ordered request stream across the fleet.

        Mutates the requests (tenant/adapter tags + swap-shifted arrival
        times) — callers pass a freshly materialized workload, one per run.
        """
        out = FleetAssignment(
            pools={m.name: [] for m in self.fleet.models},
            submitted={t.name: 0 for t in self._tenants})
        seen_adapters: set = set()
        ordered = sorted(requests, key=lambda r: r.arrival_time)
        for req in ordered:
            tenant = self._tenants[self._next_tenant()]
            req.tenant = tenant.name
            req.adapter = tenant.adapter
            out.ingress.append(tenant.name)
            out.submitted[tenant.name] += 1
            if tenant.adapter is not None:
                key = (tenant.model, tenant.adapter)
                if key not in seen_adapters:
                    seen_adapters.add(key)
                    swap = self.fleet.model(tenant.model) \
                        .adapter(tenant.adapter).swap_s
                    if swap > 0:
                        # cold load: service start jumps past the swap;
                        # the shift is re-added to reported latency
                        req.arrival_time += swap
                        out.swap_shift[req.request_id] = swap
            out.pools[tenant.model].append(req)
        return out

    def tenant_targets(self) -> List[Tuple[str, str]]:
        """(tenant, model) pairs, spec order (docs/CLI introspection)."""
        return [(t.name, t.model) for t in self._tenants]
