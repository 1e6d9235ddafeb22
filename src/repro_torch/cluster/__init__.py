"""Multi-replica cluster emulation layer (data-parallel serving, PD pools,
elastic membership, heterogeneous tiers + SLO-driven autoscaling, replicas
as threads or OS processes).

Public surface::

    from repro_torch.cluster import Cluster, build_cluster, make_router
    from repro_torch.cluster import Autoscaler, make_autoscaler_policy
    from repro_torch.cluster import TierSpec, make_tier_specs

    build_cluster(..., backend="process")   # replicas as OS processes

See ``cluster.py`` for the replica/timeline architecture and the pluggable
backend split, ``process_backend.py`` for the multi-process runtime over
the time-warp socket transport, ``router.py`` for the pluggable routing
policies, ``autoscaler.py`` for the virtual-time scaling control loop, and
``tiers.py`` for the hardware-tier arithmetic behind heterogeneous pools.
"""

from .autoscaler import (AUTOSCALER_POLICIES, Autoscaler, AutoscalerConfig,
                         AutoscalerPolicy, QueueDepthPolicy, SchedulePolicy,
                         TTFTSLOPolicy, drain_victim, make_autoscaler_policy,
                         provision_delay)
from .cluster import Cluster, ClusterBase, ClusterConfig, build_cluster
from .faults import (FAULT_KINDS, FaultInjector, FaultSpec, ON_CRASH_POLICIES,
                     SlowdownPredictor)
from .process_backend import ProcessCluster, ProcessReplicaHandle
from .router import (AdapterAffinityRouter, CostNormalizedLoadRouter,
                     LeastOutstandingTokensRouter, PDPoolRouter,
                     PrefixAffinityRouter, ReplicaView, RoundRobinRouter,
                     Router, ROUTER_POLICIES, make_router)
from .tiers import (TierSpec, make_tier_spec, make_tier_specs,
                    probe_throughput, probe_ttft, tier_engine_cfg)

__all__ = [
    "Cluster",
    "ClusterBase",
    "ClusterConfig",
    "ProcessCluster",
    "ProcessReplicaHandle",
    "build_cluster",
    "drain_victim",
    "Router",
    "ReplicaView",
    "RoundRobinRouter",
    "LeastOutstandingTokensRouter",
    "CostNormalizedLoadRouter",
    "PrefixAffinityRouter",
    "AdapterAffinityRouter",
    "PDPoolRouter",
    "ROUTER_POLICIES",
    "make_router",
    "TierSpec",
    "make_tier_spec",
    "make_tier_specs",
    "probe_throughput",
    "probe_ttft",
    "tier_engine_cfg",
    "provision_delay",
    "Autoscaler",
    "AutoscalerConfig",
    "AutoscalerPolicy",
    "QueueDepthPolicy",
    "TTFTSLOPolicy",
    "SchedulePolicy",
    "AUTOSCALER_POLICIES",
    "make_autoscaler_policy",
    "FaultSpec",
    "FaultInjector",
    "SlowdownPredictor",
    "FAULT_KINDS",
    "ON_CRASH_POLICIES",
]
