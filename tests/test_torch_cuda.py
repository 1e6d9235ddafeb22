"""The port's CUDA kernels on the card against their plain versions.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` (they build the
kernels) and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it also runs where JAX is not
installed.  Tolerances: 2e-4 in fp32, 2e-2 in bf16 (``tests/test_kernels.py``).
"""

import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.models.transformer import build_model

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,kw", [
    (2, 128, 256, 8, 2, 64, {}), (1, 100, 100, 2, 2, 64, {}), (1, 33, 126, 4, 1, 128, {}),
    (1, 8, 8, 1, 1, 32, {}), (1, 128, 128, 4, 2, 64, {"window": 16}),
    (2, 64, 80, 4, 4, 64, {"causal": False})])
def test_flash_kernel_matches_plain(gen, B, T, S, Hq, Hkv, D, kw, dtype):
    q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == 1
    exp = ops.flash_attention(q, k, v, force="plain", **kw)
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_kernel_custom_scale(gen):
    """fp32 only, as in tests/test_kernels.py: at scale 0.5 the bf16 plain
    version, which rounds q.k to bf16 before scaling, is itself more than
    2e-2 from exact."""
    q, k, v = (torch.randn((1, 64, 2, 64), generator=gen, device="cuda") for _ in range(3))
    torch.testing.assert_close(ops.flash_attention(q, k, v, softmax_scale=0.5),
                               ops.flash_attention(q, k, v, softmax_scale=0.5, force="plain"),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,page,pps", [(3, 8, 2, 64, 16, 3), (1, 4, 1, 128, 32, 2),
                                                 (4, 2, 2, 32, 8, 5)])
def test_paged_kernel_matches_plain(gen, B, Hq, Hkv, D, page, pps, dtype):
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((B * pps, page, Hkv, D), generator=gen, device="cuda").to(dtype)
    tables = torch.randperm(B * pps, generator=gen, device="cuda").int().view(B, pps)
    ctx = torch.randint(1, page * pps + 1, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    ops.reset_launch_counts()
    out = ops.paged_attention(q, kp, vp, tables, ctx)
    assert ops.launch_counts()["paged_attention"] == 1
    exp = ops.paged_attention(q, kp, vp, tables, ctx, force="plain")
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_model_with_kernels_matches_plain(gen):
    """Reduced llama3_8b in fp32: prefill, chunked prefill and decode logits
    with the kernels equal the plain attention's within 2e-3."""
    cfg = get_reduced_config("llama3_8b").replace(head_dim=32, d_model=128)
    model = build_model(cfg)
    params = model.init(gen, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=gen, device="cuda")
    logits = {}
    for force in (None, "plain"):
        cache = model.init_cache(2, 64, torch.float32)
        a, cache = model.prefill(params, {"tokens": toks[:, :24]}, cache, force=force)
        b, cache = model.prefill(params, {"tokens": toks[:, 24:40]}, cache, force=force)
        c, cache = model.decode_step(params, cache, toks[:, 40:], force=force)
        logits[force] = (a, b, c)
    for got, exp in zip(logits[None], logits["plain"]):
        torch.testing.assert_close(got, exp, rtol=2e-3, atol=2e-3)
