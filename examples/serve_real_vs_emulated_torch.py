"""End-to-end serving example on the PyTorch port: the SAME engine serving a
real model on the card, then emulated — the paper's core fidelity
demonstration (the port's counterpart of ``serve_real_vs_emulated.py``).

Phase 1 (real): Qwen2.5-3B at full width in bf16 actually executes on one
H100 — prompts in, argmax tokens out, batched continuous serving.  Step
timings are profiled into an operator-linear predictor (Vidur-style fit).
Phase 2 (emulate): the identical control plane re-serves the same request
stream with GPU work replaced by predicted time jumps.  The engine and the
stream are fig6's (``repro_torch.launch.fig6_accuracy``); the weights are
random, made from seed 0.

    PYTHONPATH=src python examples/serve_real_vs_emulated_torch.py

    # the reduced config on the CPU (a rehearsal; its times are CPU times):
    PYTHONPATH=src python examples/serve_real_vs_emulated_torch.py --reduced \\
        --device cpu --dtype float32
"""

import argparse

from repro_torch.core.device import resolve_device
from repro_torch.core.predictor import LinearPredictor
from repro_torch.launch import fig6_accuracy as fig6
from repro_torch.launch.real_vs_emulated import serve_emulated, serve_real
from repro_torch.metrics import compare_distributions


def workload():
    return fig6.small_workload(n=24, qps=15.0, seed=7)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(fig6.DTYPES))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = fig6.DTYPES[args.dtype]
    model_cfg = fig6.model_config("qwen2_5_3b", reduced=args.reduced)
    engine_cfg = fig6.engine_cfg()
    model, params = fig6.build(model_cfg, device, dtype)

    # ---- phase 1: real execution (the model genuinely runs) --------------
    print(f"phase 1: serving the real model on {device.type} ...")
    res_real, samples, _ = serve_real(model_cfg, engine_cfg, model, params, workload(),
                                      max_len=256, device=device, dtype=dtype, timeout=900)
    print(f"  served {res_real.num_requests} requests in "
          f"{res_real.wall_seconds:.1f}s wall; profiled {len(samples)} steps")

    predictor = LinearPredictor()
    predictor.fit(samples)

    # ---- phase 2: emulated execution (same engine, no model) ------------
    print("phase 2: re-serving the same stream under time-warp emulation ...")
    res_emu, _ = serve_emulated(model_cfg, engine_cfg, predictor, workload(),
                                device=device, timeout=300)
    print(f"  served {res_emu.num_requests} requests in "
          f"{res_emu.wall_seconds:.2f}s wall "
          f"({res_real.wall_seconds / max(res_emu.wall_seconds, 1e-9):.0f}x "
          f"faster than real)")

    # ---- fidelity report -------------------------------------------------
    ttft = compare_distributions(res_real.ttft, res_emu.ttft)
    tpot = compare_distributions(res_real.tpot, res_emu.tpot)
    print("\nfidelity (emulated vs real):")
    print(f"  TTFT p50  real {res_real.ttft.p50 * 1e3:7.1f} ms   "
          f"emulated {res_emu.ttft.p50 * 1e3:7.1f} ms   "
          f"err {ttft['median_rel_err']:.1%}")
    print(f"  TPOT p50  real {res_real.tpot.p50 * 1e3:7.1f} ms   "
          f"emulated {res_emu.tpot.p50 * 1e3:7.1f} ms   "
          f"err {tpot['median_rel_err']:.1%}")


if __name__ == "__main__":
    main()
