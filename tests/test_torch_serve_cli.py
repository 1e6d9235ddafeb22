"""The port's serve CLI against the reference's, and its real mode's prefix
cache on the CPU.

In the emulated modes both CLIs build the same engine (32768 blocks of 16,
prefix caching on) and the same workload (``synthesize``'s own caps and
vocabulary) from the same flags, the defaults included.  Served on a
``ManualWallSource`` (virtual time moves only through coordinated jumps),
each timeline is pure jump arithmetic, so the two summaries must agree
exactly on every key they share but the wall-clock ones.  Real mode serves
with prefix caching on: a shared prefix hits, and gives the tokens of the
same run without the cache; a model with recurrent layers is refused a
shared prefix before anything is built (ROADMAP F4-rec).
"""

import dataclasses
import json
import sys

import pytest
import torch

import repro.serving.stack as ref_stack
import repro.workload as ref_workload
from repro.core.clock import ManualWallSource as RefManualWall
from repro.launch import serve as ref_serve
from repro_torch.core.clock import ManualWallSource
from repro_torch.launch import serve

torch.set_num_threads(2)    # the suite runs in several workers at once

WALL_KEYS = {"wall_s", "speedup_x"}
BASE = ["--mode", "emulate", "--num-requests", "24"]


def _on_manual_wall(monkeypatch):
    """Both CLIs' ``build_stack`` with a ``ManualWallSource``: the
    reference's, which its ``main`` imports when it runs, and the port's."""
    ref_build, port_build = ref_stack.build_stack, serve.build_stack
    monkeypatch.setattr(ref_stack, "build_stack",
                        lambda *a, **k: ref_build(*a, wall=RefManualWall(), **k))
    monkeypatch.setattr(serve, "build_stack",
                        lambda *a, **k: port_build(*a, wall=ManualWallSource(), **k))


def _reference(monkeypatch, capsys, argv):
    """The reference CLI's summary (its ``main`` reads ``sys.argv`` and
    prints the summary as the last line under ``--json``)."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv + ["--json"])
    ref_serve.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("extra", [
    [], ["--shared-prefix", "128"], ["--policy", "sglang"], ["--arch", "llama3_70b", "--tp", "4"],
    ["--chip", "h100-sxm", "--arch", "qwen2_5_3b"]], ids=lambda e: "_".join(e) or "defaults")
def test_emulate_summary_equals_the_reference_cli(monkeypatch, capsys, extra):
    _on_manual_wall(monkeypatch)
    argv = BASE + extra
    ref = _reference(monkeypatch, capsys, argv)
    got = serve.main(argv + ["--json"])
    shared = (set(ref) & set(got)) - WALL_KEYS
    assert shared >= {"arch", "mode", "policy", "num_requests", "ttft_p50_ms", "tpot_p50_ms",
                      "makespan_virtual_s", "throughput_tok_s"}
    assert {k: got[k] for k in shared} == {k: ref[k] for k in shared}
    assert got["num_requests"] == 24


class _Captured(Exception):
    """Raised by the stand-in ``synthesize`` once both configs are kept."""


def _capture(monkeypatch, module_stack, stack_attr, module_synth, synth_attr, into):
    """Replace a CLI's ``build_stack`` and ``synthesize`` by stand-ins that
    keep the ``EngineConfig`` and the ``WorkloadConfig`` and build
    nothing."""
    class Stack:
        def shutdown(self):
            pass

    def build(model_cfg, engine_cfg, mode, **kw):
        into.update(arch=model_cfg.arch_id, engine=dataclasses.asdict(engine_cfg), mode=mode)
        return Stack()

    def synth(cfg, *a, **k):
        into["workload"] = dataclasses.asdict(cfg)
        raise _Captured

    monkeypatch.setattr(module_stack, stack_attr, build)
    monkeypatch.setattr(module_synth, synth_attr, synth)


@pytest.mark.parametrize("extra", [
    [], ["--shared-prefix", "64", "--policy", "sglang", "--chip", "h100-sxm", "--tp", "2",
         "--pp", "2", "--ep", "2", "--qps", "3.5", "--seed", "5", "--max-num-seqs", "16",
         "--chunk", "256", "--num-requests", "7", "--prompt-mean", "100",
         "--output-mean", "20", "--arch", "mixtral_8x7b"]],
    ids=["defaults", "every_flag"])
@pytest.mark.parametrize("mode", ["emulate", "sleep"])
def test_emulated_modes_build_the_reference_cli_configs(monkeypatch, mode, extra):
    """Field by field, the engine and workload configs each CLI hands to
    ``build_stack`` and ``synthesize`` for the same flags."""
    argv = ["--mode", mode] + extra
    ref, got = {}, {}
    _capture(monkeypatch, ref_stack, "build_stack", ref_workload, "synthesize", ref)
    _capture(monkeypatch, serve, "build_stack", serve, "synthesize", got)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(_Captured):
        ref_serve.main()
    with pytest.raises(_Captured):
        serve.main(argv)
    assert set(got) == set(ref) == {"arch", "engine", "mode", "workload"}
    for key in ref:
        assert got[key] == ref[key], key
    assert got["engine"]["num_blocks"] == 32768 and got["engine"]["enable_prefix_caching"]


@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_2b"])
def test_real_mode_refuses_a_shared_prefix_to_a_recurrent_model(monkeypatch, arch):
    def no_model(*_a, **_k):
        raise AssertionError("a model was built before the refusal")
    monkeypatch.setattr(serve, "build_model", no_model)
    with pytest.raises(ValueError, match="F4-rec"):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--dtype", "float32",
                    "--shared-prefix", "32"])


@pytest.mark.timeout(300)
def test_real_mode_serves_a_shared_prefix_from_the_cache(monkeypatch):
    """Reduced llama3_8b on the CPU with a 32-token shared prefix: the
    engine's prefix cache hits, and every request produces the tokens of
    the same run with prefix caching off."""
    argv = ["--arch", "llama3_8b", "--reduced", "--device", "cpu", "--dtype", "float32",
            "--shared-prefix", "32", "--max-len", "256", "--num-requests", "8", "--qps", "8"]
    port_build, port_synth, port_engine = serve.build_stack, serve.synthesize, serve.engine_config
    runs = {}
    for caching in (True, False):
        seen = {}

        def build(*a, **k):
            seen["stack"] = port_build(*a, **k)
            return seen["stack"]

        def synth(cfg, *a, **k):
            seen["reqs"] = port_synth(cfg, *a, **k)
            return seen["reqs"]

        def engine(*a, **k):
            return port_engine(*a, **dict(k, prefix_caching=caching))

        monkeypatch.setattr(serve, "build_stack", build)
        monkeypatch.setattr(serve, "synthesize", synth)
        monkeypatch.setattr(serve, "engine_config", engine)
        summary = serve.main(argv)
        assert summary["num_requests"] == 8
        assert seen["stack"].engine.cfg.enable_prefix_caching == caching
        runs[caching] = seen
    hits = runs[True]["stack"].engine.prefix_cache.stats.device_hits
    assert hits > 0 and runs[False]["stack"].engine.prefix_cache.stats.device_hits == 0
    assert sum(r.cached_prefix_len for r in runs[True]["reqs"]) > 0
    for got, exp in zip(runs[True]["reqs"], runs[False]["reqs"]):
        assert got.prompt_tokens[:32] == runs[True]["reqs"][0].prompt_tokens[:32]
        assert len(got.output_tokens) == got.max_new_tokens
        assert got.output_tokens == exp.output_tokens
