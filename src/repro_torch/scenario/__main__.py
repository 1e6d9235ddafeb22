"""Scenario CLI: run / sweep / compare serving experiments from JSON specs.

::

    python -m repro.scenario list
    python -m repro.scenario show cluster_scaling            # dump JSON
    python -m repro.scenario run cluster_scaling --backend des
    python -m repro.scenario run my_scenario.json --backend process
    python -m repro.scenario sweep cluster_scaling \\
        --axis pool.replicas=1,2,4 --axis workload.qps=4.0,24.0
    python -m repro.scenario sweep my_sweep.json             # {"base","axes"}
    python -m repro.scenario sweep cluster_scaling --jobs 4 \\
        --axis workload.qps=2,4,8,16 --derive-seeds   # parallel workers
    python -m repro.scenario compare distributed_parity \\
        --backends thread,process,des --jobs 2

Positional specs are preset names or paths to scenario JSON files; sweep
also accepts a sweep JSON file (``{"base": {...}, "axes": {...}}``).
``--out`` appends result rows as JSONL.  ``compare`` exits non-zero when
the ≤1-slow-step parity bar fails — this is the CI scenario-smoke gate.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .presets import PRESETS, describe, get_preset
from .runner import ParityError, compare, run, run_sweep
from .spec import Scenario, SpecError
from .sweep import Sweep


def _load_scenario(ref: str) -> Scenario:
    if ref in PRESETS:
        return get_preset(ref)
    path = Path(ref)
    if path.exists():
        return Scenario.load(path)
    raise SystemExit(f"error: {ref!r} is neither a preset "
                     f"({', '.join(sorted(PRESETS))}) nor a JSON file")


def _print_rows(rows) -> None:
    if not rows:
        print("(no rows)")
        return
    cols = list(dict.fromkeys(k for r in rows for k in r))
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))


def _emit(rows, out: str) -> None:
    if not out:
        return
    with open(out, "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"appended {len(rows)} rows -> {out}")


def _cmd_list(_args) -> int:
    for name in sorted(PRESETS):
        print(f"{name:22s} {describe(name)}")
    return 0


def _cmd_show(args) -> int:
    print(_load_scenario(args.spec).to_json())
    return 0


def _cmd_run(args) -> int:
    from .spec import scenario_with
    scenario = _load_scenario(args.spec)
    overrides = {}
    if args.sessions is not None:
        key = ("workload.num_sessions"
               if scenario.workload.kind == "sessions"
               else "workload.num_requests")
        overrides[key] = args.sessions
    if args.streaming:
        overrides["workload.streaming"] = True
    if getattr(args, "transport", None):
        overrides["pool.transport"] = args.transport
    if overrides:
        scenario = scenario_with(scenario, **overrides)
    res = run(scenario, backend=args.backend, timeout=args.timeout,
              audit=args.audit)
    row = res.to_row()
    _print_rows([row])
    _print_fleet(res)
    _emit([row], args.out)
    return 0


def _print_fleet(res) -> None:
    """Per-tenant rollup lines for fleet results (run/compare)."""
    if not res.tenants:
        return
    print(f"fleet: {len(res.pools or {})} pools, {len(res.tenants)} "
          f"tenants, fairness={res.fairness:.4f} "
          f"attainment={res.tenant_attainment():.4f}")
    for name, row in res.tenants.items():
        target = row["model"] + (f"+{row['adapter']}" if row["adapter"]
                                 else "")
        print(f"  tenant {name:12s} -> {target:16s} "
              f"submitted={row['submitted']} completed={row['completed']} "
              f"failed={row['failed']} attainment={row['attainment']} "
              f"goodput={row['goodput_rps']}/s")


def _cmd_sweep(args) -> int:
    if args.spec in PRESETS or not args.spec.endswith(".json"):
        sweep = Sweep(_load_scenario(args.spec), _parse_axes(args.axis))
    else:
        text = Path(args.spec).read_text()
        d = json.loads(text)
        if "axes" in d or "base" in d:
            sweep = Sweep.from_dict(d)
            if args.axis:
                sweep = Sweep(sweep.base,
                              {**sweep.axes, **_parse_axes(args.axis)})
        else:
            sweep = Sweep(Scenario.from_dict(d), _parse_axes(args.axis))
    cells = sweep.expand()
    print(f"sweep: {len(cells)} scenarios on backend={args.backend} "
          f"jobs={args.jobs}")
    results = run_sweep(cells, backend=args.backend, jobs=args.jobs,
                        timeout=args.timeout,
                        derive_seeds=args.derive_seeds)
    rows = [r.to_row() for r in results]      # cell order, jobs-independent
    _print_rows(rows)
    _emit(rows, args.out)
    return 0


def _parse_axes(axis_args) -> dict:
    axes = {}
    for a in axis_args or []:
        if "=" not in a:
            raise SystemExit(f"error: --axis needs path=v1,v2,..., got {a!r}")
        path, values = a.split("=", 1)
        parsed = []
        for v in values.split(","):
            try:
                parsed.append(json.loads(v))
            except json.JSONDecodeError:
                parsed.append(v)               # bare string (policy names)
        axes[path] = parsed
    return axes


def _cmd_compare(args) -> int:
    scenario = _load_scenario(args.spec)
    backends = tuple(args.backends.split(","))
    try:
        cres = compare(scenario, backends=backends, timeout=args.timeout,
                       jobs=args.jobs)
    except ParityError as e:
        print(f"PARITY FAILED: {e}", file=sys.stderr)
        return 1
    rows = [r.to_row() for r in cres.results.values()]
    _print_rows(rows)
    summary = cres.to_row()
    print(f"parity ok: decisions_equal={summary['decisions_equal']} "
          f"max_err={summary['max_err_steps']} slow-steps "
          f"(slow_step={cres.slow_step_s * 1e3:.0f} ms)")
    if scenario.faults:
        any_res = next(iter(cres.results.values()))
        recov = (f" mean_recovery={any_res.mean_recovery_s * 1e3:.0f} ms"
                 if any_res.recovery_times else "")
        print(f"chaos ok: faults_equal={cres.faults_equal} "
              f"injected={len(any_res.faults_injected)} "
              f"requeued={any_res.requests_requeued} "
              f"failed={any_res.requests_failed}{recov}")
    if scenario.fleet is not None:
        _print_fleet(next(iter(cres.results.values())))
    _emit(rows + [summary], args.out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.scenario",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list presets").set_defaults(fn=_cmd_list)

    p = sub.add_parser("show", help="print a scenario as JSON")
    p.add_argument("spec")
    p.set_defaults(fn=_cmd_show)

    p = sub.add_parser("run", help="run one scenario on one backend")
    p.add_argument("spec")
    p.add_argument("--backend", default="thread",
                   choices=["thread", "process", "des",
                            "process-tcp", "process-shm"])
    p.add_argument("--transport", default="",
                   choices=["", "tcp", "shm"],
                   help="override pool.transport (the process backend's "
                        "wire: framed TCP or shared-memory rings)")
    p.add_argument("--sessions", type=int, default=None,
                   help="override workload size (num_sessions for session "
                        "workloads, num_requests for open loop)")
    p.add_argument("--audit", default="full",
                   choices=["full", "sampled", "off"],
                   help="per-request retention: full (parity/figures), "
                        "sampled (O(1)-memory sketches + SLO reservoir), "
                        "off (sketches only)")
    p.add_argument("--streaming", action="store_true",
                   help="force the lazy streaming workload form")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", default="", help="append rows as JSONL")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("sweep", help="expand a grid and run every cell")
    p.add_argument("spec", help="preset, scenario JSON, or sweep JSON")
    p.add_argument("--axis", action="append",
                   help="dotted.path=v1,v2,... (repeatable)")
    p.add_argument("--backend", default="thread",
                   choices=["thread", "process", "des",
                            "process-tcp", "process-shm"])
    p.add_argument("--jobs", type=int, default=1,
                   help="fan cells across N worker processes "
                        "(results identical to --jobs 1, same order)")
    p.add_argument("--derive-seeds", action="store_true",
                   help="derive a deterministic per-cell seed from each "
                        "cell name instead of inheriting the base seed")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", default="", help="append rows as JSONL")
    p.set_defaults(fn=_cmd_sweep)

    p = sub.add_parser("compare",
                       help="run one scenario on several backends + parity")
    p.add_argument("spec")
    p.add_argument("--backends", default="thread,des",
                   help="comma-separated subset of thread,process,des "
                        "(plus the process-tcp/process-shm wire aliases)")
    p.add_argument("--jobs", type=int, default=1,
                   help="run the backend legs in N parallel workers")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", default="", help="append rows as JSONL")
    p.set_defaults(fn=_cmd_compare)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except SpecError as e:
        print(f"spec error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
