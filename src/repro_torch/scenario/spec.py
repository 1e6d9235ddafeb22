"""Declarative scenario specs: one serializable tree describes an experiment.

A :class:`Scenario` is a frozen dataclass tree — workload shape, replica
pool, routing policy, autoscaling, SLOs, seed — that fully determines a
serving experiment without naming an execution backend.  The same spec runs
unmodified on the thread-mode emulator, the process-mode emulator, and the
DES baseline through :func:`repro.scenario.run`, which is what turns a
config sweep into *data* instead of hand-wired Python (the paper's §2.1
hundreds-of-configurations story; see ``docs/scenarios.md``).

Serialization contract (tested in ``tests/test_scenario.py``):

* ``Scenario.from_dict(s.to_dict()) == s`` for every valid scenario — the
  dict form is plain JSON (tuples become lists and come back as tuples);
* unknown keys and invalid enum values raise :class:`SpecError` carrying the
  dotted **path** of the offending entry (``"autoscale.policy"``), so a
  typo'd 200-line JSON file fails with a pointer, not a stack trace;
* every field has a default — ``Scenario.from_dict({})`` is a valid tiny
  scenario, and spec files only need to name what they change.

>>> s = Scenario(name="demo", pool=PoolSpec(replicas=2))
>>> Scenario.from_dict(s.to_dict()) == s
True
>>> Scenario.from_json(s.to_json()) == s
True
>>> try:
...     Scenario.from_dict({"pool": {"replicaz": 2}})
... except SpecError as e:
...     print(str(e).split(" (")[0])
pool.replicaz: unknown key
>>> try:
...     Scenario.from_dict({"routing": {"policy": "warp_drive"}})
... except SpecError as e:
...     print(str(e).split(" (")[0])
routing.policy: invalid value 'warp_drive'
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.cluster.faults import FaultSpec

__all__ = [
    "SpecError",
    "WorkloadSpec",
    "PoolSpec",
    "RoutingSpec",
    "AutoscaleSpec",
    "SLOSpec",
    "FaultSpec",
    "Scenario",
    "scenario_with",
    "BACKENDS",
]

#: Execution backends a scenario can run on (see repro.scenario.runner).
BACKENDS = ("thread", "process", "des")


class SpecError(ValueError):
    """Invalid scenario spec; the message starts with the dotted path of the
    offending entry (e.g. ``"autoscale.provision_delay_by_tier"``)."""


# =========================================================================
# generic dataclass <-> JSON-dict codec
# =========================================================================

def _encode(value):
    """Spec tree -> plain JSON value (tuples -> lists, dataclasses -> dicts)."""
    if dataclasses.is_dataclass(value):
        return {f.name: _encode(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _encode(v) for k, v in value.items()}
    return value


def _decode(typ, value, path: str):
    """JSON value -> ``typ``, raising :class:`SpecError` at ``path``."""
    origin = typing.get_origin(typ)
    args = typing.get_args(typ)

    # Optional[X] / Union[X, None]
    if origin is typing.Union:
        non_none = [a for a in args if a is not type(None)]
        if value is None:
            if type(None) in args:
                return None
            raise SpecError(f"{path}: may not be null")
        assert len(non_none) == 1, f"unsupported union at {path}"
        return _decode(non_none[0], value, path)

    if dataclasses.is_dataclass(typ):
        return _decode_dataclass(typ, value, path)

    if origin is tuple:
        if not isinstance(value, (list, tuple)):
            raise SpecError(f"{path}: expected a list, got {value!r}")
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_decode(args[0], v, f"{path}[{i}]")
                         for i, v in enumerate(value))
        if len(value) != len(args):
            raise SpecError(f"{path}: expected {len(args)} elements, "
                            f"got {len(value)}")
        return tuple(_decode(a, v, f"{path}[{i}]")
                     for i, (a, v) in enumerate(zip(args, value)))

    if origin is dict:
        if not isinstance(value, dict):
            raise SpecError(f"{path}: expected an object, got {value!r}")
        key_t, val_t = args
        return {_decode(key_t, k, f"{path}.{k}"):
                _decode(val_t, v, f"{path}.{k}")
                for k, v in value.items()}

    if typ is dict:                      # free-form kwargs: plain JSON only
        if not isinstance(value, dict):
            raise SpecError(f"{path}: expected an object, got {value!r}")
        try:
            return json.loads(json.dumps(value))  # deep copy + JSON-only
        except TypeError as e:
            raise SpecError(f"{path}: values must be plain JSON ({e})") \
                from None

    if typ is bool:
        if not isinstance(value, bool):
            raise SpecError(f"{path}: expected a bool, got {value!r}")
        return value
    if typ is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise SpecError(f"{path}: expected an int, got {value!r}")
        return value
    if typ is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SpecError(f"{path}: expected a number, got {value!r}")
        return float(value)
    if typ is str:
        if not isinstance(value, str):
            raise SpecError(f"{path}: expected a string, got {value!r}")
        return value
    raise AssertionError(f"unsupported spec field type {typ} at {path}")


def _type_hints(cls):
    """``typing.get_type_hints`` with the fleet extension specs in scope.

    ``Scenario.fleet`` is annotated as a *forward reference* to
    :class:`repro.fleet.FleetSpec` so the import stays one-directional
    (``repro.fleet.spec`` imports the codec from this module).  Resolving
    the hints therefore needs the fleet names injected into the lookup
    namespace — lazily, at decode time, to avoid the cycle.
    """
    import sys
    globalns = dict(getattr(sys.modules.get(cls.__module__), "__dict__", {}))
    if "FleetSpec" not in globalns:
        from repro_torch.fleet.spec import FleetSpec
        globalns["FleetSpec"] = FleetSpec
    return typing.get_type_hints(cls, globalns=globalns)


def _decode_dataclass(cls, value, path: str):
    if isinstance(value, cls):
        return value
    if not isinstance(value, dict):
        raise SpecError(f"{path}: expected an object for {cls.__name__}, "
                        f"got {value!r}")
    hints = _type_hints(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    kwargs = {}
    for key, v in value.items():
        kpath = f"{path}.{key}" if path else key
        if key not in names:
            raise SpecError(f"{kpath}: unknown key "
                            f"(valid keys: {', '.join(names)})")
        kwargs[key] = _decode(hints[key], v, kpath)
    out = cls(**kwargs)
    validate = getattr(out, "validate", None)
    if validate is not None:
        validate(path=path)
    return out


class _SpecBase:
    """Shared codec surface for every spec dataclass."""

    def to_dict(self) -> dict:
        """Plain-JSON dict form (tuples become lists); full and explicit —
        every field is present, so specs diff cleanly."""
        return _encode(self)

    @classmethod
    def from_dict(cls, d: dict, *, path: str = ""):
        """Strict inverse of :meth:`to_dict`: unknown keys / wrong types /
        invalid enum values raise :class:`SpecError` with the dotted path."""
        return _decode_dataclass(
            cls, d, path or cls.__name__.lower().replace("spec", ""))

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, text: str):
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"invalid JSON: {e}") from None
        return cls.from_dict(d)

    def validate(self, *, path: str = "") -> None:
        """Semantic checks beyond types; subclasses override and raise
        :class:`SpecError` (with ``path`` prefixes) on violations."""


def _enum(path: str, name: str, value: str, valid) -> None:
    if value not in valid:
        raise SpecError(f"{path}.{name}: invalid value {value!r} "
                        f"(choose from {sorted(valid)})")


# =========================================================================
# the spec tree
# =========================================================================

@dataclass(frozen=True)
class WorkloadSpec(_SpecBase):
    """Traffic shape: open-loop request stream or closed-loop chat sessions.

    ``kind="open"`` materializes a :func:`repro.workload.synthesize` stream
    (``num_requests`` × the length marginals); ``kind="sessions"``
    materializes a :class:`repro.workload.SessionWorkload` (multi-turn chat,
    follow-ups released on completion + think time).  ``arrival`` names any
    registered arrival process — ``"uniform"`` gives the deterministically
    spaced arrivals backend-parity scenarios need.

    ``streaming=True`` swaps the materialized forms for their lazy
    equivalents (:class:`repro.workload.StreamingWorkload` /
    :class:`repro.workload.StreamingSessionWorkload`): requests are
    generated with bounded look-ahead instead of being pre-built, so one
    spec can replay millions of sessions in flat memory (pair with
    ``audit="sampled"`` on :func:`repro.scenario.run`).
    """

    kind: str = "open"                    # open | sessions
    qps: float = 4.0                      # request (or session) arrival rate
    arrival: str = "poisson"              # repro.workload.ARRIVAL_PROCESSES
    arrival_kwargs: Optional[dict] = None   # e.g. {"cv2": 8.0} for gamma
    # length marginals (lognormal, shared by both kinds)
    prompt_len_mean: float = 180.0
    prompt_len_sigma: float = 0.6
    output_len_mean: float = 40.0
    output_len_sigma: float = 0.6
    max_output_len: int = 256
    shared_prefix_len: int = 0            # common system prompt (tokens)
    # open-loop shape
    num_requests: int = 32
    max_prompt_len: int = 2048            # sessions bound context instead
    # closed-loop shape
    num_sessions: int = 8
    turns_mean: float = 3.0
    max_turns: int = 5
    think_time_mean: float = 1.0
    followup_len_mean: float = 40.0
    # lazy generation (flat-memory scale path); default keeps the
    # materialized forms every existing scenario/parity test uses
    streaming: bool = False

    def validate(self, *, path: str = "workload") -> None:
        from repro_torch.workload import ARRIVAL_PROCESSES, make_arrival
        _enum(path, "kind", self.kind, ("open", "sessions"))
        _enum(path, "arrival", self.arrival, ARRIVAL_PROCESSES)
        if self.qps <= 0:
            raise SpecError(f"{path}.qps: must be > 0")
        if self.kind == "open" and self.num_requests < 1:
            raise SpecError(f"{path}.num_requests: must be >= 1")
        if self.kind == "sessions" and self.num_sessions < 1:
            raise SpecError(f"{path}.num_sessions: must be >= 1")
        # the kwargs must actually fit the chosen process: fail here with a
        # path, not at materialize time with a raw TypeError mid-sweep
        try:
            make_arrival(self.arrival, self.qps,
                         **(self.arrival_kwargs or {}))
        except (TypeError, ValueError, AssertionError) as e:
            raise SpecError(
                f"{path}.arrival_kwargs: invalid for arrival "
                f"{self.arrival!r} ({e})") from None

    @property
    def total_label(self) -> str:
        return (f"{self.num_requests} reqs" if self.kind == "open"
                else f"{self.num_sessions} sessions")

    def materialize(self, seed: int):
        """Build the runnable workload object (a fresh one per call): a
        ``List[Request]`` for ``kind="open"``, a :class:`SessionWorkload`
        for ``kind="sessions"`` — or their lazy streaming equivalents when
        ``streaming=True``."""
        from repro_torch.workload import (SessionConfig, SessionWorkload,
                                    StreamingSessionWorkload,
                                    StreamingWorkload, WorkloadConfig,
                                    synthesize)
        if self.kind == "sessions":
            cfg = SessionConfig(
                num_sessions=self.num_sessions, qps=self.qps,
                arrival=self.arrival, arrival_kwargs=self.arrival_kwargs,
                turns_mean=self.turns_mean, max_turns=self.max_turns,
                think_time_mean=self.think_time_mean,
                prompt_len_mean=self.prompt_len_mean,
                prompt_len_sigma=self.prompt_len_sigma,
                followup_len_mean=self.followup_len_mean,
                output_len_mean=self.output_len_mean,
                output_len_sigma=self.output_len_sigma,
                max_output_len=self.max_output_len,
                shared_prefix_len=self.shared_prefix_len,
                seed=seed)
            if self.streaming:
                return StreamingSessionWorkload(cfg)
            return SessionWorkload(cfg)
        cfg = WorkloadConfig(
            num_requests=self.num_requests, qps=self.qps,
            arrival=self.arrival, arrival_kwargs=self.arrival_kwargs,
            prompt_len_mean=self.prompt_len_mean,
            prompt_len_sigma=self.prompt_len_sigma,
            output_len_mean=self.output_len_mean,
            output_len_sigma=self.output_len_sigma,
            max_prompt_len=self.max_prompt_len,
            max_output_len=self.max_output_len,
            shared_prefix_len=self.shared_prefix_len,
            seed=seed)
        if self.streaming:
            return StreamingWorkload(cfg)
        return synthesize(cfg)


@dataclass(frozen=True)
class PoolSpec(_SpecBase):
    """The replica pool: model, engine knobs, hardware tiers, predictor.

    ``tiers`` makes the pool heterogeneous — one chip name per replica (a
    single name broadcasts to all), resolved through
    :mod:`repro.cluster.tiers` so routing weights, KV capacity, and
    $/replica-second follow the chip identically on every backend.
    ``step_time_s`` (or per-tier ``tier_step_time_s``) pins a
    :class:`~repro.core.predictor.StaticPredictor` — the deterministic
    step-time parity scenarios use; ``None`` selects the analytical
    predictor for the chip.
    """

    model: str = "llama3_8b"              # repro.configs registry id
    reduced: bool = False                 # reduced() config (CI-sized runs)
    replicas: int = 2
    tiers: Optional[Tuple[str, ...]] = None
    # engine knobs (EngineConfig)
    scheduler: str = "vllm"               # vllm | sglang
    max_num_seqs: int = 8
    max_batched_tokens: int = 512
    block_size: int = 16
    num_blocks: int = 16384
    chip: str = "h200-sxm"                # ignored when tiers are set
    tp: int = 1
    ep: int = 1
    enable_prefix_caching: bool = True
    # predictor override: virtual step seconds (None = analytical predictor)
    step_time_s: Optional[float] = None
    tier_step_time_s: Optional[Dict[str, float]] = None
    # process-backend wire: "tcp" (framed sockets) | "shm" (shared-memory
    # rings + seqlock clock word); thread/des backends have no wire and
    # ignore it, so parity scenarios stay backend-portable
    transport: str = "tcp"

    def validate(self, *, path: str = "pool") -> None:
        from repro_torch.configs import ARCH_IDS, PAPER_ARCH_IDS
        from repro_torch.core.hardware import get_chip
        valid_models = set(ARCH_IDS) | set(PAPER_ARCH_IDS)
        _enum(path, "model", self.model, valid_models)
        _enum(path, "scheduler", self.scheduler, ("vllm", "sglang"))
        _enum(path, "transport", self.transport, ("tcp", "shm"))
        if self.replicas < 1:
            raise SpecError(f"{path}.replicas: must be >= 1")
        if self.tiers is not None:
            if len(self.tiers) not in (1, self.replicas):
                raise SpecError(
                    f"{path}.tiers: need 1 (broadcast) or {self.replicas} "
                    f"tier names, got {len(self.tiers)}")
            for i, t in enumerate(self.tiers):
                try:
                    get_chip(t)
                except KeyError:
                    raise SpecError(f"{path}.tiers[{i}]: unknown chip/tier "
                                    f"{t!r}") from None
        for t in (self.tier_step_time_s or {}):
            try:
                get_chip(t)
            except KeyError:
                raise SpecError(f"{path}.tier_step_time_s.{t}: unknown "
                                f"chip/tier {t!r}") from None

    def replica_tiers(self) -> Optional[list]:
        """Per-replica tier names with single-name broadcast applied."""
        if self.tiers is None:
            return None
        if len(self.tiers) == 1:
            return [self.tiers[0]] * self.replicas
        return list(self.tiers)

    def model_config(self):
        from repro_torch.configs import get_config, get_reduced_config
        return (get_reduced_config(self.model) if self.reduced
                else get_config(self.model))

    def engine_config(self):
        from repro_torch.serving.scheduler import EngineConfig
        return EngineConfig(
            policy=self.scheduler, max_num_seqs=self.max_num_seqs,
            max_batched_tokens=self.max_batched_tokens,
            block_size=self.block_size, num_blocks=self.num_blocks,
            chip=self.chip, tp=self.tp, ep=self.ep,
            enable_prefix_caching=self.enable_prefix_caching)


@dataclass(frozen=True)
class RoutingSpec(_SpecBase):
    """Request placement policy (see :mod:`repro.cluster.router`)."""

    policy: str = "round_robin"
    kwargs: Optional[dict] = None         # router constructor extras

    def validate(self, *, path: str = "routing") -> None:
        from repro_torch.cluster.router import ROUTER_POLICIES
        _enum(path, "policy", self.policy, ROUTER_POLICIES)


@dataclass(frozen=True)
class AutoscaleSpec(_SpecBase):
    """Elastic membership: policy + control-loop config (+ tier candidates).

    ``policy="schedule"`` takes its scripted ``(virtual_time, delta)`` events
    from ``schedule`` (times relative to the run's virtual start — the
    deterministic shape every parity scenario uses); the feedback policies
    (``queue_depth``, ``ttft_slo``) take their knobs from ``kwargs``.
    """

    policy: str = "queue_depth"           # repro.cluster AUTOSCALER_POLICIES
    kwargs: Optional[dict] = None         # policy constructor extras
    schedule: Optional[Tuple[Tuple[float, int], ...]] = None
    interval_s: float = 0.25
    provision_delay_s: float = 1.0
    min_replicas: int = 1
    max_replicas: int = 8
    tiers: Tuple[str, ...] = ()           # scale-up tier candidates
    provision_delay_by_tier: Optional[Dict[str, float]] = None

    def validate(self, *, path: str = "autoscale") -> None:
        from repro_torch.cluster.autoscaler import AUTOSCALER_POLICIES
        from repro_torch.core.hardware import get_chip
        _enum(path, "policy", self.policy, AUTOSCALER_POLICIES)
        if (self.policy == "schedule") != (self.schedule is not None):
            raise SpecError(
                f"{path}.schedule: required exactly when policy='schedule'")
        if self.kwargs and self.policy == "schedule":
            raise SpecError(f"{path}.kwargs: schedule policy takes its "
                            "events from 'schedule', not kwargs")
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise SpecError(f"{path}.min_replicas/max_replicas: need "
                            "1 <= min <= max")
        for i, t in enumerate(self.tiers):
            try:
                get_chip(t)
            except KeyError:
                raise SpecError(f"{path}.tiers[{i}]: unknown chip/tier "
                                f"{t!r}") from None

    def make_policy(self):
        from repro_torch.cluster.autoscaler import (SchedulePolicy,
                                              make_autoscaler_policy)
        if self.policy == "schedule":
            return SchedulePolicy([tuple(e) for e in self.schedule])
        return make_autoscaler_policy(self.policy, **(self.kwargs or {}))

    def make_config(self):
        from repro_torch.cluster.autoscaler import AutoscalerConfig
        return AutoscalerConfig(
            interval_s=self.interval_s,
            provision_delay_s=self.provision_delay_s,
            min_replicas=self.min_replicas,
            max_replicas=self.max_replicas,
            tiers=tuple(self.tiers),
            provision_delay_by_tier=(dict(self.provision_delay_by_tier)
                                     if self.provision_delay_by_tier
                                     else None))


@dataclass(frozen=True)
class SLOSpec(_SpecBase):
    """Service-level objectives the result's attainment/goodput are judged
    against (``None`` = unconstrained on that axis)."""

    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None

    def validate(self, *, path: str = "slo") -> None:
        for name, v in (("ttft_s", self.ttft_s), ("tpot_s", self.tpot_s)):
            if v is not None and v <= 0:
                raise SpecError(f"{path}.{name}: must be > 0 (or null)")


@dataclass(frozen=True)
class Scenario(_SpecBase):
    """One fully-specified serving experiment (see module docstring).

    The tree is frozen: derive variants with :func:`scenario_with` (dotted
    field paths) or :class:`dataclasses.replace`, and grids with
    :class:`repro.scenario.Sweep`.
    """

    name: str = "scenario"
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    pool: PoolSpec = field(default_factory=PoolSpec)
    routing: RoutingSpec = field(default_factory=RoutingSpec)
    autoscale: Optional[AutoscaleSpec] = None
    slo: SLOSpec = field(default_factory=SLOSpec)
    faults: Tuple[FaultSpec, ...] = ()    # chaos schedule (virtual times)
    # multi-model / multi-tenant extension (repro.fleet): when set, the
    # fleet's per-model pools replace the top-level pool/routing/autoscale
    # (which are ignored) and tenants split the open-loop workload
    fleet: Optional["FleetSpec"] = None
    seed: int = 0

    def validate(self, *, path: str = "") -> None:
        dot = f"{path}." if path else ""
        self.workload.validate(path=f"{dot}workload")
        self.pool.validate(path=f"{dot}pool")
        self.routing.validate(path=f"{dot}routing")
        self.slo.validate(path=f"{dot}slo")
        for i, f in enumerate(self.faults):
            f.validate(path=f"{dot}faults[{i}]")
            if f.kind == "spot_reclaim" and not self.pool.tiers:
                raise SpecError(f"{dot}faults[{i}].tier: spot_reclaim needs "
                                "a tiered pool (pool.tiers)")
        if self.faults:
            if self.routing.policy == "pd_pool":
                raise SpecError(f"{dot}faults: fault injection is not "
                                "supported for pd_pool routing")
            if self.workload.kind == "sessions" and any(
                    f.on_crash == "fail" for f in self.faults
                    if f.kind in ("crash", "spot_reclaim")):
                raise SpecError(
                    f"{dot}faults: on_crash='fail' cannot be combined with a "
                    "sessions workload (a failed turn would strand its "
                    "session's follow-ups and the run would never complete); "
                    "use on_crash='requeue'")
        if self.fleet is not None:
            self.fleet.validate(path=f"{dot}fleet")
            if self.workload.kind != "open":
                raise SpecError(
                    f"{dot}fleet: needs workload.kind='open' (the ingress "
                    "splits one open-loop stream across tenants; sessions "
                    "are per-pool concerns)")
            if self.workload.streaming:
                raise SpecError(f"{dot}fleet: streaming workloads are not "
                                "supported on the fleet path yet")
            if self.faults:
                raise SpecError(f"{dot}faults: fault injection composes at "
                                "pool level, not fleet level (run the pool's "
                                "scenario with faults instead)")
            if self.autoscale is not None:
                raise SpecError(
                    f"{dot}autoscale: a fleet scales per model pool "
                    "(fleet.models[i].autoscale); top-level autoscale "
                    "must be null")
        if self.autoscale is not None:
            self.autoscale.validate(path=f"{dot}autoscale")
            a = self.autoscale
            if self.pool.replicas < a.min_replicas \
                    or self.pool.replicas > a.max_replicas:
                raise SpecError(
                    f"{dot}pool.replicas: initial pool ({self.pool.replicas})"
                    f" outside autoscale bounds "
                    f"[{a.min_replicas}, {a.max_replicas}]")
            if self.routing.policy == "pd_pool":
                raise SpecError(f"{dot}autoscale: elastic membership is not "
                                "supported for pd_pool routing")

    @classmethod
    def from_dict(cls, d: dict, *, path: str = "") -> "Scenario":
        return _decode_dataclass(cls, d, path)

    def save(self, path) -> None:
        from pathlib import Path
        Path(path).write_text(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "Scenario":
        from pathlib import Path
        return cls.from_json(Path(path).read_text())


# =========================================================================
# dotted-path derivation (Sweep axes, figure grids)
# =========================================================================

def scenario_with(scenario: Scenario, **overrides) -> Scenario:
    """A copy of ``scenario`` with dotted field paths replaced.

    Keys use ``__`` as the nesting separator when passed as kwargs, or dots
    when passed via the mapping form ``scenario_with(s, **{"pool.replicas":
    4})``.  Values pass through the same strict decoding as
    :meth:`Scenario.from_dict` (lists coerce to tuples, enums validate), so
    sweep axes stay plain JSON.

    >>> s = Scenario()
    >>> scenario_with(s, **{"pool.replicas": 4}).pool.replicas
    4
    >>> scenario_with(s, workload__qps=9.0).workload.qps
    9.0
    >>> try:
    ...     scenario_with(s, **{"pool.nope": 1})
    ... except SpecError as e:
    ...     print(str(e).split(" (")[0])
    pool.nope: unknown key
    """
    out = scenario
    for key, value in overrides.items():
        parts = key.replace("__", ".").split(".")
        out = _replace_path(out, parts, value, path=key.replace("__", "."))
    out.validate()
    return out


def _replace_path(node, parts, value, *, path: str):
    name = parts[0]
    fields_by_name = {f.name: f for f in dataclasses.fields(node)}
    if name not in fields_by_name:
        raise SpecError(f"{path}: unknown key (valid keys: "
                        f"{', '.join(fields_by_name)})")
    hints = _type_hints(type(node))
    if len(parts) == 1:
        new = _decode(hints[name], value, path)
        return dataclasses.replace(node, **{name: new})
    child = getattr(node, name)
    if child is None:                    # e.g. autoscale on a fixed pool
        raise SpecError(f"{path}: cannot set a nested field on "
                        f"{name}=null; set the whole object instead")
    if not dataclasses.is_dataclass(child):
        raise SpecError(f"{path}: {name} is not a nested spec")
    new_child = _replace_path(child, parts[1:], value, path=path)
    return dataclasses.replace(node, **{name: new_child})
