"""Pluggable request routing for multi-replica serving (data-parallel mode).

A :class:`Router` decides which replica serves each request.  Policies are
*engine-agnostic*: they see replicas only through the tiny
:class:`ReplicaView` protocol (load + prefix-cache probes), so the very same
policy objects route the time-warp emulator's real ``LLMEngine`` replicas
(``repro.cluster.Cluster``) **and** the DES baseline's simulated replicas
(``repro.des.simulator.MultiReplicaSimulator``).  Sharing the policy code is
what extends the paper's §2.3 semantic-gap argument to cluster scale: any
emulator-vs-DES divergence at N replicas is attributable to engine-semantics
re-implementation, never to a routing difference.

Policies
--------
``round_robin``
    Cyclic assignment; ignores replica state.  Deterministic, the baseline.
``least_outstanding_tokens``
    Place on the replica with the fewest remaining scheduled tokens
    (prefill left + decode left) — the token-aware analogue of
    least-outstanding-requests, robust to skewed prompt lengths.  On a
    heterogeneous pool the backlog is divided by the replica's tier
    throughput weight, so "fewest tokens" becomes "shortest estimated
    drain time" (an idle L4 should not outrank a lightly loaded H100 that
    clears its queue sooner).
``prefix_affinity``
    Score replicas by their radix prefix-cache hit potential for the
    request's prompt and route to the best scorer; unseen prefixes fall
    back to least-outstanding placement and are remembered (sticky key on
    the prompt head) so a session's follow-ups land on the replica already
    holding its KV.
``pd_pool``
    Prefill/decode disaggregation as a routing policy: the replica set is
    split into a prefill pool and a decode pool; fresh requests go to the
    least-loaded prefill replica, and after the KV handoff the cluster asks
    :meth:`PDPoolRouter.route_decode` for the decode-side placement.  This
    unifies ``repro.serving.disagg`` behind the same Router interface.
``adapter_affinity``
    Multi-LoRA placement (``repro.fleet``): requests tagged with an adapter
    name stick to the replica that already holds that adapter's weights
    (first placement by shortest drain), so each adapter is resident on one
    replica and swap churn is minimized; untagged (base-model) traffic is
    placed by shortest drain.  A sticky replica that drains away triggers a
    deterministic re-placement.
``cost_normalized_load``
    Heterogeneous-pool placement by *marginal dollar cost*: each replica is
    scored by its estimated drain time (weighted backlog, as in
    ``least_outstanding_tokens``) multiplied by its tier's $/replica-second,
    so comparable load lands on the cheaper tier while a genuinely shorter
    queue on an expensive tier still wins.  With no tier info configured
    every weight/cost is 1.0 and the policy degrades to exactly
    ``least_outstanding_tokens``.

Tier info reaches a router through :meth:`Router.set_tier` (and the
``weight``/``cost`` keywords of :meth:`Router.grow` for autoscale-added
replicas); both the emulated :class:`~repro.cluster.cluster.Cluster` and the
DES baseline derive those numbers from the same
:class:`~repro.cluster.tiers.TierSpec` objects, so identically-constructed
router instances behave identically on both sides.

Invariant: ``route`` only ever returns an index from the ``active`` list it
was given — a draining or not-yet-provisioned replica can never receive a
fresh request, whatever the policy.  Deterministic tie-breaking (lowest
index) is part of every policy's contract; it is what makes same-seed runs
byte-identical.

>>> class V:
...     def __init__(self, tokens): self._t = tokens
...     def outstanding_tokens(self): return self._t
...     def prefix_match_len(self, toks): return 0
>>> r = make_router("least_outstanding_tokens", 2)
>>> r.route(None, [V(100), V(40)])
1
>>> r.set_tier(0, weight=4.0)          # replica 0 is a 4x-faster tier
>>> r.route(None, [V(100), V(40)])     # 100/4 = 25 beats 40/1
0
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence, Tuple

__all__ = [
    "ReplicaView",
    "Router",
    "RoundRobinRouter",
    "LeastOutstandingTokensRouter",
    "CostNormalizedLoadRouter",
    "PrefixAffinityRouter",
    "AdapterAffinityRouter",
    "PDPoolRouter",
    "ROUTER_POLICIES",
    "make_router",
]


class ReplicaView(Protocol):
    """What a routing policy may observe about one replica.

    Implementations are cheap, non-blocking, racy-read probes: an engine
    replica answers from lock-free counters, a DES replica from its event
    state.  Policies must tolerate (and tie-break deterministically under)
    slightly stale values.
    """

    def outstanding_tokens(self) -> int: ...

    def prefix_match_len(self, tokens: Sequence[int]) -> int: ...


class Router:
    """Base router: maps each request to a replica index in [0, n).

    Elastic membership: ``route`` takes an optional ``active`` index list —
    the replicas a request may currently land on (autoscaling: draining
    replicas leave it, freshly provisioned ones join it).  ``num_replicas``
    grows via :meth:`grow` when the cluster adds a replica; policies must
    only ever pick from ``active``.

    Heterogeneous pools: ``weights[i]`` (tier decode throughput, default 1.0)
    and ``costs[i]`` ($/replica-second, default 0.0 = untiered) let policies
    normalize load and price placement per replica.  Both lists always cover
    ``num_replicas`` entries.
    """

    def __init__(self, num_replicas: int):
        assert num_replicas >= 1
        self.num_replicas = num_replicas
        self.decisions: List[int] = []       # audit log (tests/benchmarks)
        self.record_decisions = True         # False: skip the log (scale runs)
        self.weights: List[float] = [1.0] * num_replicas
        self.costs: List[float] = [0.0] * num_replicas

    def route(self, req, views: Sequence[ReplicaView],
              active: Optional[Sequence[int]] = None) -> int:
        """Place one request; returns the chosen replica index.

        ``views`` are the per-replica :class:`ReplicaView` probes (racy,
        non-blocking reads); ``active`` restricts the choice to the current
        routing membership.  The chosen index is appended to
        :attr:`decisions` — the audit log tests and benchmarks replay.
        """
        act = list(active) if active is not None else list(range(len(views)))
        assert act, "routing needs at least one active replica"
        idx = self._pick(req, views, act)
        assert idx in act, f"policy picked inactive replica {idx}"
        if self.record_decisions:
            self.decisions.append(idx)
        return idx

    def _pick(self, req, views: Sequence[ReplicaView],
              active: List[int]) -> int:
        raise NotImplementedError

    def set_tier(self, idx: int, *, weight: float = 1.0,
                 cost: float = 0.0) -> None:
        """Record replica ``idx``'s tier throughput weight and $/second."""
        assert 0 <= idx < self.num_replicas and weight > 0
        self.weights[idx] = weight
        self.costs[idx] = cost

    def grow(self, num_replicas: int, *, weight: float = 1.0,
             cost: float = 0.0) -> None:
        """Cluster scale-up: the replica index space expanded.  ``weight``/
        ``cost`` describe the tier of every newly added index (scale-up adds
        one replica at a time in practice)."""
        assert num_replicas >= self.num_replicas
        while len(self.weights) < num_replicas:
            self.weights.append(weight)
            self.costs.append(cost)
        self.num_replicas = num_replicas

    # replicas a fresh request may land on (overridden by pd_pool)
    def intake_indices(self) -> List[int]:
        return list(range(self.num_replicas))

    # ------------------------------------------------ tier-aware scoring --
    def _drain_time(self, views, i: int) -> float:
        """Estimated seconds to clear replica ``i``'s backlog: outstanding
        tokens over tier throughput.  With default weights this orders
        replicas exactly like raw outstanding tokens."""
        return views[i].outstanding_tokens() / self.weights[i]

    def _shortest_drain(self, views, indices) -> int:
        """Lowest-load replica among ``indices`` by estimated drain time
        (tier-weighted; plain outstanding tokens on homogeneous pools);
        lowest index wins ties so the decision is deterministic under equal
        (or stale-equal) loads."""
        return min(indices, key=lambda i: (self._drain_time(views, i), i))


class RoundRobinRouter(Router):
    """Cyclic assignment over the *active* set.  A plain counter modulo the
    current membership reproduces ``itertools.cycle`` exactly for a static
    cluster and keeps cycling deterministically as replicas join/leave."""

    policy = "round_robin"

    def __init__(self, num_replicas: int):
        super().__init__(num_replicas)
        self._rr = -1

    def _pick(self, req, views, active) -> int:
        self._rr += 1
        return active[self._rr % len(active)]


class LeastOutstandingTokensRouter(Router):
    """Shortest estimated drain time (= fewest outstanding tokens on a
    homogeneous pool; tier-throughput-normalized on a mixed one)."""

    policy = "least_outstanding_tokens"

    def _pick(self, req, views, active) -> int:
        return self._shortest_drain(views, active)


class CostNormalizedLoadRouter(Router):
    """Cheapest marginal placement on a heterogeneous pool.

    Score per replica: estimated drain time × tier $/second — roughly "what
    does parking this request behind replica *i*'s queue cost".  Untiered
    replicas (cost 0.0) are scored with cost 1.0 so the policy stays a
    well-defined load balancer on homogeneous pools.  Ties break toward the
    cheaper tier, then the lower index.
    """

    policy = "cost_normalized_load"

    def _pick(self, req, views, active) -> int:
        def score(i: int):
            cost = self.costs[i] if self.costs[i] > 0 else 1.0
            return (self._drain_time(views, i) * cost, cost, i)
        return min(active, key=score)


class PrefixAffinityRouter(Router):
    """Route by radix prefix-cache hit potential (session affinity).

    The probe answers "how many prompt tokens does replica i already hold?";
    the best scorer wins (ties to lower load).  A request whose prefix no
    replica holds yet is placed least-outstanding and its prompt head is
    remembered, so same-session requests that arrive *before* the first one
    has populated the cache still co-locate (the sticky map is the router's
    own state, not a cache re-implementation — the actual hit accounting
    stays inside the engine's radix tree).
    """

    policy = "prefix_affinity"

    def __init__(self, num_replicas: int, *, affinity_key_len: int = 32):
        super().__init__(num_replicas)
        self.affinity_key_len = affinity_key_len
        self._sticky: Dict[Tuple[int, ...], int] = {}

    def _key(self, tokens: Sequence[int]) -> Tuple[int, ...]:
        return tuple(tokens[: self.affinity_key_len])

    def _pick(self, req, views, active) -> int:
        toks = getattr(req, "prompt_tokens", None)
        if not toks:
            # No routing key (e.g. a DES SimRequest built from lengths
            # only): nothing to be affine to — place by load.
            return self._shortest_drain(views, active)
        tokens = list(toks)
        scores = {i: views[i].prefix_match_len(tokens) for i in active}
        best = max(scores.values())
        if best > 0:
            idx = min((i for i in active if scores[i] == best),
                      key=lambda i: (self._drain_time(views, i), i))
            self._sticky[self._key(tokens)] = idx
            return idx
        key = self._key(tokens)
        idx = self._sticky.get(key)
        if idx is None or idx not in active:
            # unseen session, or its sticky replica drained away: re-place
            idx = self._shortest_drain(views, active)
            self._sticky[key] = idx
        return idx


class AdapterAffinityRouter(Router):
    """Sticky adapter→replica placement for multi-LoRA pools.

    The fleet ingress tags each request with the LoRA adapter it must be
    served with (``req.adapter``; ``None`` = base model).  The first request
    for an adapter is placed on the shortest-drain replica and the mapping
    is remembered, so subsequent requests for that adapter land where its
    weights (and its sessions' KV) already live — one resident replica per
    adapter, no swap churn.  Base-model traffic load-balances by shortest
    drain.  If a sticky replica leaves the active set (drain/crash) the
    adapter is deterministically re-placed.

    The sticky map is router state shared verbatim by the emulator and the
    DES (both see the same tag on the same request in the same order), so
    adapter placements are part of the audited decision log that parity
    compares.
    """

    policy = "adapter_affinity"

    def __init__(self, num_replicas: int):
        super().__init__(num_replicas)
        self._sticky: Dict[str, int] = {}

    def _pick(self, req, views, active) -> int:
        adapter = getattr(req, "adapter", None)
        if not adapter:
            return self._shortest_drain(views, active)
        idx = self._sticky.get(adapter)
        if idx is None or idx not in active:
            idx = self._shortest_drain(views, active)
            self._sticky[adapter] = idx
        return idx

    def adapter_placements(self) -> Dict[str, int]:
        """Current adapter→replica residency (audit/introspection)."""
        return dict(self._sticky)


class PDPoolRouter(Router):
    """Prefill/decode pool split (DistServe/Splitwise-style) as routing.

    The first ``num_prefill`` replicas form the prefill pool; the rest form
    the decode pool.  ``route`` places fresh requests on the least-loaded
    prefill replica; ``route_decode`` places KV-migrated requests on the
    least-loaded decode replica (the cluster calls it after the emulated KV
    transfer lands).
    """

    policy = "pd_pool"

    def __init__(self, num_replicas: int, *, num_prefill: Optional[int] = None):
        super().__init__(num_replicas)
        assert num_replicas >= 2, "pd_pool needs at least one of each pool"
        self.num_prefill = num_prefill if num_prefill is not None \
            else max(1, num_replicas // 2)
        assert 1 <= self.num_prefill < num_replicas
        self.prefill_indices = list(range(self.num_prefill))
        self.decode_indices = list(range(self.num_prefill, num_replicas))

    def intake_indices(self) -> List[int]:
        return list(self.prefill_indices)

    def _pick(self, req, views, active) -> int:
        pool = [i for i in self.prefill_indices if i in active]
        assert pool, "pd_pool: no active prefill replica"
        return self._shortest_drain(views, pool)

    def route_decode(self, req, views: Sequence[ReplicaView],
                     active: Optional[Sequence[int]] = None) -> int:
        pool = (self.decode_indices if active is None
                else [i for i in self.decode_indices if i in active])
        assert pool, "pd_pool: no active decode replica"
        return self._shortest_drain(views, pool)


ROUTER_POLICIES = {
    cls.policy: cls
    for cls in (RoundRobinRouter, LeastOutstandingTokensRouter,
                CostNormalizedLoadRouter, PrefixAffinityRouter,
                AdapterAffinityRouter, PDPoolRouter)
}


def make_router(policy: str, num_replicas: int, **kwargs) -> Router:
    """Build a fresh router (routers are stateful — one per run).

    >>> make_router("round_robin", 2).policy
    'round_robin'
    >>> sorted(ROUTER_POLICIES)      # doctest: +NORMALIZE_WHITESPACE
    ['adapter_affinity', 'cost_normalized_load', 'least_outstanding_tokens',
     'pd_pool', 'prefix_affinity', 'round_robin']
    """
    try:
        cls = ROUTER_POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown routing policy {policy!r}; "
            f"choose from {sorted(ROUTER_POLICIES)}") from None
    return cls(num_replicas, **kwargs)
