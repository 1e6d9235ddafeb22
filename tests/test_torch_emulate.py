"""The port's time-warp emulator against the reference's, and its entry points
on the CPU.

Both packages' ``build_stack(mode="emulate")`` serve the same synthesized
stream for the full ``llama3_8b`` config on an emulated H100, on a
``ManualWallSource`` (virtual time moves only through coordinated jumps), so
each timeline is pure jump arithmetic: the reference repeats itself bit for
bit there, and the port must give exactly its per-request TTFTs and token
times and its runner's step estimates (tolerance 0).  The same holds for the
``tp=2`` worker group (the reference's three runs of this stream were
bit-identical) and for the step estimates of sleep mode.  The emulated modes
touch no device: they dispatch no torch operation at all.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_config
from repro.core.clock import ManualWallSource as RefManualWall
from repro.core.emulation import VirtualOOMError as RefVirtualOOM
from repro.core.predictor import StaticPredictor as RefStatic
from repro.serving.benchmark import BenchmarkRunner as RefRunner
from repro.serving.scheduler import EngineConfig as RefEngineConfig
from repro.serving.stack import build_stack as ref_build_stack
from repro.workload import WorkloadConfig as RefWorkload
from repro.workload import synthesize as ref_synthesize
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.clock import ManualWallSource
from repro_torch.core.emulation import VirtualOOMError
from repro_torch.core.predictor import StaticPredictor
from repro_torch.launch import real_vs_emulated, serve
from repro_torch.serving import stack as stack_mod
from repro_torch.serving.benchmark import BenchmarkRunner
from repro_torch.serving.model_runner import SleepModelRunner, TimeWarpModelRunner
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.serving.stack import build_stack
from repro_torch.workload import WorkloadConfig, synthesize

torch.set_num_threads(2)    # the suite runs in several workers at once

PORT = dict(config=get_config, wall=ManualWallSource, static=StaticPredictor,
            engine=EngineConfig, build=build_stack, runner=BenchmarkRunner,
            workload=WorkloadConfig, synthesize=synthesize)
REF = dict(config=ref_config, wall=RefManualWall, static=RefStatic,
           engine=RefEngineConfig, build=ref_build_stack, runner=RefRunner,
           workload=RefWorkload, synthesize=ref_synthesize)
STREAM = dict(num_requests=32, qps=4.0, prompt_len_mean=400, seed=3)


def _emulate(pkg, *, policy="vllm", predictor=None, tp=1, worker_group=False,
             arch="llama3_8b"):
    """Serve STREAM in emulate mode; per-request (TTFT, token times) in
    arrival order, and the runner's step estimates."""
    engine_cfg = pkg["engine"](policy=policy, max_num_seqs=8, max_batched_tokens=512,
                               block_size=16, num_blocks=4096, chip="h100-sxm", tp=tp)
    pred = None if predictor is None else pkg["static"](predictor)
    stack = pkg["build"](pkg["config"](arch), engine_cfg, "emulate", predictor=pred,
                         wall=pkg["wall"](), use_worker_group=worker_group)
    reqs = pkg["synthesize"](pkg["workload"](**STREAM))
    try:
        res = pkg["runner"](stack.engine, reqs, transport=stack.transport).run(timeout=60)
    finally:
        stack.shutdown()
    assert res.num_requests == len(reqs)
    assert all(r.num_generated == r.max_new_tokens for r in reqs)
    return [(r.ttft(), r.token_times) for r in reqs], stack.runner.step_estimates


@pytest.mark.parametrize("predictor", [None, 4e-3], ids=["analytical", "static"])
@pytest.mark.parametrize("policy", ["vllm", "sglang"])
def test_emulate_equals_the_reference(policy, predictor):
    port = _emulate(PORT, policy=policy, predictor=predictor)
    ref = _emulate(REF, policy=policy, predictor=predictor)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert len(port[1]) > len(port[0])


def test_emulate_worker_group_equals_the_reference():
    """tp=2 through a WorkerGroup: two worker actors and a collective barrier
    per step; exact, as the reference repeats itself exactly."""
    port = _emulate(PORT, tp=2, worker_group=True)
    ref = _emulate(REF, tp=2, worker_group=True)
    assert port == ref
    assert port[1][0]["collective"] > 0


def _sleep(pkg):
    engine_cfg = pkg["engine"](policy="vllm", max_num_seqs=8, max_batched_tokens=512,
                               block_size=16, num_blocks=4096, chip="h100-sxm")
    stack = pkg["build"](pkg["config"]("llama3_8b"), engine_cfg, "sleep",
                         predictor=pkg["static"](1e-3), wall=pkg["wall"]())
    reqs = pkg["synthesize"](pkg["workload"](**{**STREAM, "num_requests": 16}))
    stack.engine.submit_many(reqs)
    try:
        stack.engine.start()
        assert stack.engine.wait_until_complete(len(reqs), timeout=60)
    finally:
        stack.shutdown()
    return stack.runner.step_estimates


def test_sleep_mode_step_estimates_equal_the_reference():
    port, ref = _sleep(PORT), _sleep(REF)
    assert port == ref
    assert len(port) > 16


def test_virtual_oom_for_70b_on_one_h100():
    """llama3_70b's 140 GB of bf16 weights do not fit one virtual H100: a
    prediction of the emulator, in both packages."""
    for pkg, err in ((PORT, VirtualOOMError), (REF, RefVirtualOOM)):
        engine_cfg = pkg["engine"](max_num_seqs=8, block_size=16, num_blocks=4096,
                                   chip="h100-sxm")
        with pytest.raises(err):
            pkg["build"](pkg["config"]("llama3_70b"), engine_cfg, "emulate",
                         wall=pkg["wall"](), use_worker_group=False)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["emulate", "sleep"])
def test_emulated_modes_touch_no_device(mode, monkeypatch):
    """The engine stepped in this thread under a dispatch mode that sees
    every torch operation, factory calls included: none runs.  Nothing asks
    for a device either."""
    def no_device(*_a, **_k):
        raise AssertionError("an emulated mode asked for a device")
    monkeypatch.setattr(stack_mod, "resolve_device", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    engine_cfg = EngineConfig(max_num_seqs=8, max_batched_tokens=512, block_size=16,
                              num_blocks=4096, chip="h100-sxm")
    with _CountOps() as seen:
        stack = build_stack(get_config("llama3_8b"), engine_cfg, mode,
                            predictor=StaticPredictor(1e-3), wall=ManualWallSource(),
                            use_worker_group=False)
        reqs = synthesize(WorkloadConfig(num_requests=6, seed=5))
        for r in reqs:
            stack.engine.scheduler.add_request(r)
        try:
            while not all(r.finished for r in reqs):
                stack.engine.step()
        finally:
            stack.shutdown()
    assert seen.ops == []
    assert isinstance(stack.runner, {"emulate": TimeWarpModelRunner,
                                     "sleep": SleepModelRunner}[mode])


def test_serve_cli_emulates_full_llama3_8b_without_weights(monkeypatch, capsys):
    def no_model(*_a, **_k):
        raise AssertionError("emulate mode built a model")
    monkeypatch.setattr(serve, "build_model", no_model)
    summary = serve.main(["--mode", "emulate", "--arch", "llama3_8b",
                          "--num-requests", "24", "--qps", "4", "--json"])
    assert summary["num_requests"] == 24
    assert summary["arch"] == "llama3_8b" and summary["chip"] == "h100-sxm"
    assert summary["makespan_virtual_s"] > summary["wall_s"]
    assert '"mode": "emulate"' in capsys.readouterr().out


@pytest.mark.timeout(300)
def test_real_vs_emulated_rehearsal_on_the_cpu(capsys):
    report = real_vs_emulated.main(["--reduced", "--device", "cpu", "--dtype", "float32"])
    assert report["arch"] == "llama3_8b_reduced"
    for key in ("calibration", "real", "emulate_linear", "emulate_analytical"):
        assert report[key]["num_requests"] == 8
        assert report[key]["launches"] == {"flash_attention": 0, "flash_attention_bwd": 0,
                                           "paged_attention": 0, "ssd_scan": 0,
                                           "ssd_scan_bwd": 0}
    assert min(report["linear_coef"]) >= 0.0
    assert report["linear_coef"] != [0.0] * 4
    for key in ("emulate_linear", "emulate_analytical"):
        assert set(report[key]["ttft_err"]) >= {"p50_rel_err", "p99_rel_err"}
        assert report[key]["wall_s"] > 0
    assert "speed-up" in capsys.readouterr().out


# =========================================================================
# the emulate-mode cases of tests/test_system.py, on a ManualWallSource
# =========================================================================
# Left out: test_emulation_accelerates and test_emulate_matches_sleep_
# distributions compare against the real wall (its speed-up and the sleep
# baseline's wall-clock timeline); the disaggregated cluster and the DES
# baseline are held in tests/test_torch_cluster.py and test_torch_cluster_parity.py.

def _system_run(policy="vllm", batch_s=4e-3, n=40, qps=20.0, jitter_cooldown=0.0,
                prefix_caching=True, **wl):
    cfg = EngineConfig(policy=policy, max_num_seqs=16, max_batched_tokens=128,
                       block_size=4, num_blocks=4096,
                       enable_prefix_caching=prefix_caching)
    stack = build_stack(get_reduced_config("qwen2_5_3b"), cfg, "emulate",
                        predictor=StaticPredictor(batch_s), use_worker_group=False,
                        jitter_cooldown=jitter_cooldown, wall=ManualWallSource())
    reqs = synthesize(WorkloadConfig(**{
        **dict(num_requests=n, qps=qps, prompt_len_mean=48, output_len_mean=12,
               max_prompt_len=128, max_output_len=32, seed=7), **wl}))
    try:
        res = BenchmarkRunner(stack.engine, reqs, transport=stack.transport).run(120)
    finally:
        stack.shutdown()
    return res, reqs, stack


def test_all_requests_complete_exactly():
    res, reqs, _ = _system_run(n=25, qps=50.0)
    assert res.num_requests == 25
    assert len({r.request_id for r in reqs}) == 25
    for r in reqs:
        assert r.num_generated == r.max_new_tokens


def test_policy_split_visible_in_tpot():
    """SGLang-style prefill priority starves decodes under prefill pressure:
    a worse TPOT tail than vLLM-style mixed batching."""
    res_vllm, _, _ = _system_run("vllm", batch_s=5e-3, qps=40.0)
    res_sgl, _, _ = _system_run("sglang", batch_s=5e-3, qps=40.0)
    assert res_sgl.tpot.p99 > res_vllm.tpot.p99 * 1.05, (res_sgl.tpot.p99,
                                                          res_vllm.tpot.p99)


def test_prefix_caching_reduces_prefill_work():
    shared = dict(n=30, qps=30.0, shared_prefix_len=64, prompt_len_mean=96, batch_s=5e-3)
    res_on, _, on = _system_run(**shared)
    res_off, _, off = _system_run(prefix_caching=False, **shared)
    assert len(on.engine.step_log) < len(off.engine.step_log)
    assert res_on.ttft.mean <= res_off.ttft.mean + 1e-9


def test_jitter_cooldown_slows_but_stays_correct():
    res, _, stack = _system_run(batch_s=2e-3, n=10, qps=50.0, jitter_cooldown=2e-3)
    assert res.num_requests == 10
    assert stack.timekeeper.stats.cooldown_waits > 0


def test_worker_group_collective_exit_is_max_of_ranks():
    from repro_torch.core.client import LocalTransport
    from repro_torch.core.clock import VirtualClock
    from repro_torch.core.timekeeper import Timekeeper
    from repro_torch.serving.workers import WorkerGroup

    tk = Timekeeper(clock=VirtualClock(ManualWallSource()), jitter_cooldown=0.0)
    # rank 1 is 50% slower (MoE imbalance): the group exits with the slowest
    wg = WorkerGroup(LocalTransport(tk), 2, name="tp", jitter=[0.0, 0.5])
    t0 = tk.clock.now()
    wg.execute_step(0.1)
    assert tk.clock.now() - t0 == pytest.approx(0.15, abs=1e-12)
    wg.shutdown()
    tk.close()
