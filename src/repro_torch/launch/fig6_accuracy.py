"""Fig. 6 — end-to-end accuracy: time-warp emulation against real execution
of the same engine, on three architectures, beside the real-vs-real noise
floor.  The port's counterpart of the reference's
``benchmarks/fig6_accuracy.py``, with the real side on the card.

    # the three architectures at full width in bf16 on one H100
    # (mixtral_8x7b at 16 of its 32 layers: 87 GB of weights do not fit):
    PYTHONPATH=src python -m repro_torch.launch.fig6_accuracy

    # the reduced configs on the CPU in fp32 (a rehearsal; its times are
    # CPU times):
    PYTHONPATH=src python -m repro_torch.launch.fig6_accuracy --reduced \\
        --device cpu --dtype float32

For each architecture, as the reference's ``measure`` does: a calibration
stream (seed 123) is served in real mode and a ``LinearPredictor`` is fitted
on its steps; the evaluation stream (seed 7) is then served twice in real
mode and once emulated.  Every error is the emulated run's against the
first real run (``compare_distributions``); the floor is the second real
run's against the first.  The engine and the streams are the reference's,
field by field (:func:`engine_cfg`, :func:`small_workload`), with one
difference on the card: the emulated engine names the card's chip
(``h100-sxm``), since the default ``tpu-v5e``'s 16 GB of virtual memory
cannot hold the full-width weights that emulation allocates there.  With a
fitted predictor the chip moves no time.

Each row has exactly the reference's keys, rounded as it rounds them.  The
facts of the run (the card, the dtype, the layers built, each phase's
steps, kernel launches and allocated bytes, the fitted coefficients, the
TPOT floor, the requests whose tokens parted between the two real runs) go
to ``facts``.  A request
that did not finish or did not get its tokens raises, as does a real run on
the card that never launched K1 or K2, and an emulated run that launched a
kernel or changed the allocated device memory; the sizes of the errors are
only reported.  The weights are random, made from seed 0.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.device import resolve_device
from repro_torch.core.predictor import LinearPredictor
from repro_torch.launch import real_vs_emulated as rve
from repro_torch.metrics import compare_distributions
from repro_torch.models.config import ModelConfig
from repro_torch.models.optim import tree_leaves
from repro_torch.serving.scheduler import EngineConfig

ARCHS = ["qwen2_5_3b", "granite_8b", "mixtral_8x7b"]
# depth built at full width where the whole model does not fit one card
CARD_LAYERS = {"mixtral_8x7b": 16}
CARD_CHIP = "h100-sxm"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
WEIGHTS_SEED = 0
TIMEOUT = 900


def small_workload(n=40, qps=20.0, seed=0, **kw):
    """CPU-runnable workload for real-mode fidelity benchmarks (a copy of
    the reference's ``benchmarks.common.small_workload``)."""
    from repro_torch.workload import WorkloadConfig, synthesize
    base = dict(num_requests=n, qps=qps, prompt_len_mean=24.0,
                output_len_mean=8.0, max_prompt_len=96, max_output_len=16,
                vocab_size=500, seed=seed)
    base.update(kw)
    return synthesize(WorkloadConfig(**base))


def print_table(rows: List[Dict], cols: Optional[List[str]] = None) -> None:
    """A copy of the reference's ``benchmarks.common.print_table``."""
    if not rows:
        print("(no rows)")
        return
    cols = cols or list(rows[0].keys())
    widths = {c: max(len(c), *(len(_fmt(r.get(c))) for r in rows)) for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(_fmt(r.get(c)).ljust(widths[c]) for c in cols))


def _fmt(v) -> str:
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1e4 or abs(v) < 1e-3:
            return f"{v:.3e}"
        return f"{v:.4g}"
    return str(v)


def engine_cfg(**kw):
    base = dict(policy="vllm", max_num_seqs=8, max_batched_tokens=64,
                block_size=4, num_blocks=4096)
    base.update(kw)
    return EngineConfig(**base)


def model_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    """The reduced config, or the full one at ``CARD_LAYERS``' depth where
    it has one, else at its whole depth."""
    if reduced:
        return get_reduced_config(arch)
    cfg = get_config(arch)
    if arch in CARD_LAYERS:
        cfg = cfg.replace(num_layers=CARD_LAYERS[arch], layer_pattern=None)
    return cfg


def build(cfg: ModelConfig, device, dtype):
    """The model and its weights from ``WEIGHTS_SEED``; the parameter count
    must be the config's."""
    from repro_torch.models.transformer import build_model
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(WEIGHTS_SEED), dtype, device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{cfg.arch_id}: {n_params} parameters, the config "
                             f"says {cfg.param_count()}")
    return model, params


def run_real(arch: str, reqs, model, params, *, max_len=256, device=None,
             dtype=torch.bfloat16):
    """``reqs`` in real mode on a stack of their own, with ``model`` (of
    ``arch``) and ``params``.  The reference builds the model anew for each
    run; :func:`measure` builds it once (:func:`build`, seed 0, so the same
    weights) and passes it to its three runs.  Returns the result, the
    runner's ``(BatchSpec, seconds)`` samples and the phase record
    (``real_vs_emulated._Phase``)."""
    device = resolve_device(device)
    res, samples, record = rve.serve_real(
        model.cfg, engine_cfg(), model, params, reqs, max_len=max_len, device=device,
        dtype=dtype, timeout=TIMEOUT)
    launched = record["launches"]
    if (device.type == "cuda" and model.cfg.num_attn_layers()
            and (launched["flash_attention"] <= 0 or launched["paged_attention"] <= 0)):
        raise AssertionError(f"{arch}: K1 or K2 never launched in a real run: {launched}")
    return res, samples, record


def run_emulated(arch: str, reqs, predictor, *, reduced=False,
                 chip: Optional[str] = None, device=None):
    """``reqs`` under time-warp emulation with ``predictor``, on an engine
    that names ``chip`` (the reference's default where None), for the model
    of :func:`model_config`.  Returns the result and the phase record; a
    launch or, on the card, a change of the allocated bytes raises."""
    device = resolve_device(device)
    cfg = model_config(arch, reduced=reduced)
    engine = engine_cfg() if chip is None else engine_cfg(chip=chip)
    res, record = rve.serve_emulated(cfg, engine, predictor, reqs, device=device,
                                     timeout=TIMEOUT)
    if any(record["launches"].values()) or record["allocated_delta_bytes"]:
        raise AssertionError(f"{arch}: the emulated run launched {record['launches']} and "
                             f"changed the allocated bytes by "
                             f"{record['allocated_delta_bytes']}")
    return res, record


def card(device: torch.device) -> Dict[str, Optional[str]]:
    """The card's name and power limit, as ``nvidia-smi`` gives them (None
    on the CPU)."""
    if device.type != "cuda":
        return {"name": None, "nvidia_smi": None}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"unavailable ({e})"
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def measure(arch: str, n: int = 30, *, reduced=False, device=None,
            dtype=torch.bfloat16, facts: Optional[Dict] = None) -> dict:
    """Calibrate, fit, real, real again, emulated; the reference's row.
    Where ``facts`` is a dict, the run's facts are written into it."""
    t0 = time.monotonic()
    device = resolve_device(device)
    cfg = model_config(arch, reduced=reduced)
    model, params = build(cfg, device, dtype)
    try:
        # calibration workload (disjoint seed) -> operator-linear predictor
        calib = small_workload(n=max(10, n // 2), qps=15.0, seed=123)
        _, samples, calib_rec = run_real(arch, calib, model, params, device=device,
                                         dtype=dtype)
        table = LinearPredictor()
        table.fit(samples)

        # evaluation: same stream through real (twice: noise floor) and emulated
        evals = [small_workload(n=n, qps=15.0, seed=7) for _ in range(2)]
        res_real, _, real_rec = run_real(arch, evals[0], model, params, device=device,
                                         dtype=dtype)
        res_real2, _, real2_rec = run_real(arch, evals[1], model, params, device=device,
                                           dtype=dtype)
    finally:
        # free the weights before the next architecture
        del model, params
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    chip = CARD_CHIP if device.type == "cuda" else None
    res_emu, emu_rec = run_emulated(arch, small_workload(n=n, qps=15.0, seed=7), table,
                                    reduced=reduced, chip=chip, device=device)

    ttft = compare_distributions(res_real.ttft, res_emu.ttft)
    tpot = compare_distributions(res_real.tpot, res_emu.tpot)
    noise = compare_distributions(res_real.ttft, res_real2.ttft)
    if facts is not None:
        tpot_noise = compare_distributions(res_real.tpot, res_real2.tpot)
        facts.update({
            **card(device), "dtype": str(dtype).replace("torch.", ""), "reduced": reduced,
            "layers": cfg.num_layers,
            "layers_of": (get_reduced_config if reduced else get_config)(arch).num_layers,
            "parameters": cfg.param_count(), "emulated_chip": chip or engine_cfg().chip,
            "phases": {"calibration": calib_rec, "real": real_rec, "real2": real2_rec,
                       "emulated": emu_rec},
            "linear_coef": [float(c) for c in table._coef],   # 1, prefill tokens,
            # decode seqs, total context (``LinearPredictor._features``)
            "real_noise_floor_p99": round(noise["p99_rel_err"], 4),
            "tpot_noise_floor": round(tpot_noise["median_rel_err"], 4),
            "tpot_noise_floor_p99": round(tpot_noise["p99_rel_err"], 4),
            "requests_parted": sum(a.output_tokens != b.output_tokens
                                   for a, b in zip(*evals)),
            "seconds": round(time.monotonic() - t0, 1)})
    return {
        "arch": arch,
        "n": n,
        "real_ttft_p50_ms": round(res_real.ttft.p50 * 1e3, 3),
        "emu_ttft_p50_ms": round(res_emu.ttft.p50 * 1e3, 3),
        "ttft_p50_err": round(ttft["median_rel_err"], 4),
        "ttft_p99_err": round(ttft["p99_rel_err"], 4),
        "tpot_p50_err": round(tpot["median_rel_err"], 4),
        "tpot_p99_err": round(tpot["p99_rel_err"], 4),
        # run-to-run variability of real execution: the measurement noise
        # floor any predictor is bound by
        "real_noise_floor": round(noise["median_rel_err"], 4),
        "real_wall_s": round(res_real.wall_seconds, 2),
        "emu_wall_s": round(res_emu.wall_seconds, 2),
        "speedup_vs_real": round(
            res_real.wall_seconds / max(res_emu.wall_seconds, 1e-9), 2),
    }


def rows(n: int = 30, *, archs=ARCHS, facts: Optional[Dict] = None, **kw) -> list:
    """One row an architecture; ``facts``, where a dict, gets each one's
    facts by name."""
    return [measure(a, n, facts=None if facts is None else facts.setdefault(a, {}), **kw)
            for a in archs]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+", default=ARCHS)
    ap.add_argument("--n", type=int, default=30, help="evaluation requests")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs (CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    facts: Dict[str, Dict] = {}
    out = rows(args.n, archs=args.archs, facts=facts, reduced=args.reduced,
               device=device, dtype=DTYPES[args.dtype])
    print_table(out)
    worst = max(r["ttft_p50_err"] for r in out)
    floor = max(r["real_noise_floor"] for r in out)
    where = (f"an {facts[out[0]['arch']]['nvidia_smi']}" if device.type == "cuda"
             else "the CPU")
    print(f"fig6: worst median TTFT error {worst:.2%} vs a real-vs-real "
          f"run-to-run noise floor of {floor:.2%} on {where} "
          f"(paper: <5% on dedicated H200s)")
    for r in out:
        print(json.dumps({"row": r, "facts": facts[r["arch"]]}))
    return out


if __name__ == "__main__":
    main()
