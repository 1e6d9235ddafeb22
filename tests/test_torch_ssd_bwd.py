"""K3's gradient kernel, in the parts that run on the CPU.

``ref.ssd_scan_bwd_two_pass`` spells out ``csrc/ssd_scan_bwd.cu`` in plain
PyTorch: the reverse scan of the state gradient over the chunks, the
per-(chunk, head) products for dxdt, dB, dC and dcum, the reverse cumsum
that turns dcum into ddA, and the heads' partials of dB and dC summed in
order.  It is held against ``jax.vjp`` of the JAX package's
``repro.models.layers.ssd_chunked_ref`` (every input's gradient, 1e-5) where
the reference takes the length (T a multiple of the chunk): the port in
fp32 on fp32 inputs, the reference on the same values in fp64 (under
``jax.enable_x64``), since in fp32 the reference's own cumsum of dA rounds
by about 1e-5 (``ref.ssd_scan_chunked`` explains it), which would make the
check measure the reference's rounding rather than the port's gradient; and
against autograd through the port's plain scan ``ref.ssd_scan_chunked`` at
ragged lengths, which the reference does not take.  Then the wrapper's
checks, its C interface against the source, and the dispatch: on the CPU
``ops.ssd_scan`` is differentiated by autograd through the plain version.
The kernel itself runs on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 3f).

Inputs are made with numpy from a seed and handed to both packages.
"""

import ast
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import ssd_chunked_ref as jax_ssd_chunked_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan_bwd as bwd_mod
from repro_torch.models import transformer

torch.set_num_threads(2)    # the suite runs in several workers at once

KERNELS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "kernels"
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, T, H, P, N):
    """The reference's inputs (xh, dt, A, B, C), an initial state, and
    cotangents of y and of the final state, fp32 numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((B, T, H))).astype(np.float32)   # softplus
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    dy = rng.standard_normal((B, T, H, P)).astype(np.float32)
    d_final = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return xh, dt, A, Bm, Cm, s0, dy, d_final


def _jax_grads(xdt, dA, Bm, Cm, s0, dy, dT, chunk, dtype):
    """``jax.vjp`` of the reference's chunked scan with respect to K3's own
    inputs (xdt, dA, B, C and the initial state): the reference takes (xh,
    dt, A) and forms xdt = xh·dt and dA = dt·A inside, so it is called with
    dt = −dA, A = −1 and xh = xdt / dt, which give back xdt and dA."""
    def f(xdt, dA, Bm, Cm, *s0):
        dt = -dA
        init = s0[0] if s0 else jnp.zeros(dT.shape, dtype)
        return jax_ssd_chunked_ref(xdt / dt[..., None], dt, -jnp.ones(dA.shape[-1], dtype),
                                   Bm, Cm, chunk=chunk, initial_state=init)
    primals = [jnp.asarray(a, dtype) for a in (xdt, dA, Bm, Cm)] + (
        [] if s0 is None else [jnp.asarray(s0, dtype)])
    _, vjp = jax.vjp(f, *primals)
    return [np.asarray(e) for e in vjp((jnp.asarray(dy, dtype), jnp.asarray(dT, dtype)))]


@pytest.mark.parametrize("d_final", [False, True])
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("N,P", [(4, 16), (16, 32), (4, 32), (16, 16)])
def test_plain_decomposition_matches_jax_vjp(N, P, carry, d_final):
    """Three chunks of 16 and four of 32: the gradient of every input
    (xdt, dA, B, C and the initial state) within 1e-5 of ``jax.vjp`` of the
    reference's chunked scan."""
    for T, chunk in ((48, 16), (128, 32)):
        xh, dt, A, Bm, Cm, s0, dy, dT = _inputs(N + P + T, 2, T, 3, P, N)
        xdt, dA = xh * dt[..., None], dt * A
        s0 = s0 if carry else None
        dT = dT if d_final else np.zeros_like(dT)
        with jax.enable_x64(True):
            exp = _jax_grads(xdt, dA, Bm, Cm, s0, dy, dT, chunk, jnp.float64)
        got = ref.ssd_scan_bwd_two_pass(
            *(torch.from_numpy(a) for a in (xdt, dA, Bm, Cm, dy)), chunk=chunk,
            initial_state=None if s0 is None else torch.from_numpy(s0),
            d_final=torch.from_numpy(dT) if d_final else None)
        got = [g for g in got if g is not None]
        assert len(got) == len(exp)
        for name, g, e in zip(("xdt", "dA", "B", "C", "initial_state"), got, exp):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), e, **TOL,
                                       err_msg=f"T={T} chunk={chunk}: gradient of {name}")


@pytest.mark.parametrize("T,chunk,carry", [(37, 16, True), (5, 16, False), (130, 128, True),
                                           (379, 128, True), (100, 32, False)])
def test_plain_decomposition_at_ragged_lengths(T, chunk, carry):
    """A ragged last chunk, which the reference cannot take: every
    gradient against autograd through ``ref.ssd_scan_chunked``."""
    xh, dt, A, Bm, Cm, s0, dy, dT = _inputs(T, 2, T, 2, 16, 8)
    xdt = torch.from_numpy(xh * dt[..., None]).requires_grad_()
    dA = torch.from_numpy(dt * A).requires_grad_()
    B_t, C_t = (torch.from_numpy(a).requires_grad_() for a in (Bm, Cm))
    ins = [xdt, dA, B_t, C_t]
    s = None
    if carry:
        s = torch.from_numpy(s0).requires_grad_()
        ins.append(s)
    y, st = ref.ssd_scan_chunked(xdt, dA, B_t, C_t, chunk=chunk, initial_state=s)
    exp = torch.autograd.grad([y, st], ins, [torch.from_numpy(dy), torch.from_numpy(dT)])
    got = ref.ssd_scan_bwd_two_pass(*(x.detach() for x in ins[:4]), torch.from_numpy(dy),
                                    chunk=chunk, initial_state=None if s is None else s.detach(),
                                    d_final=torch.from_numpy(dT))
    assert (got[4] is None) == (not carry)
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, **TOL)


def test_plain_decomposition_without_a_final_gradient_is_zero_there():
    """``d_final=None`` is a zero cotangent of the final state."""
    xh, dt, A, Bm, Cm, s0, dy, dT = _inputs(3, 1, 40, 2, 16, 8)
    args = [torch.from_numpy(a) for a in (xh * dt[..., None], dt * A, Bm, Cm)]
    none = ref.ssd_scan_bwd_two_pass(*args, torch.from_numpy(dy), chunk=16)
    zero = ref.ssd_scan_bwd_two_pass(*args, torch.from_numpy(dy), chunk=16,
                                     d_final=torch.zeros_like(torch.from_numpy(dT)))
    for a, b in zip(none[:4], zero[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_refuses_cpu_tensors():
    xh, dt, A, Bm, Cm, s0, dy, _ = _inputs(4, 1, 32, 2, 16, 8)
    args = [torch.from_numpy(a) for a in (xh, dt * A, Bm, Cm, dy)]
    carry = torch.zeros((1, 1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bwd_mod.ssd_scan_bwd(*args, carry, torch.from_numpy(s0), chunk=32)


def test_wrapper_reads_no_device_value_and_has_no_fallback():
    """The wrapper plans from shapes alone (no .item(), .tolist(), .cpu() or
    .numpy()), so that a backward can be captured in a CUDA graph, and has
    no try around the launch: a CUDA tensor launches the kernel or raises.
    ``ops`` has no try either."""
    for module in ("ssd_scan_bwd.py", "ops.py"):
        tree = ast.parse((KERNELS / module).read_text())
        reads = [node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)
                 and node.attr in ("item", "tolist", "cpu", "numpy")]
        assert reads == [], module
        assert not any(isinstance(node, ast.Try) for node in ast.walk(tree)), module


def test_wrapper_argtypes_follow_the_c_interface():
    """The ctypes argument list of ``_kernel`` is the C function's, type by
    type: a pointer passed as a 32-bit int would be cut."""
    source = (KERNELS / "csrc" / "ssd_scan_bwd.cu").read_text()
    sig = re.search(r'extern "C" int ssd_scan_bwd\((.*?)\) \{', source, re.S).group(1)
    kinds = []
    for param in sig.split(","):
        words = param.split()
        kinds.append("p" if "*" in param else "ll" if words[:2] == ["long", "long"] else "i")
    expect = ["p"] * 19 + ["i"] * 6 + ["ll"] * 10 + ["i", "p"]
    assert kinds == expect
    assert "fn.argtypes = [p] * 19 + [i] * 6 + [ll] * 10 + [i, p]" in (
        KERNELS / "ssd_scan_bwd.py").read_text()


def test_cpu_autograd_goes_through_the_plain_version():
    """On the CPU ``ops.ssd_scan`` with gradients is autograd through the
    plain version: no kernel is launched, and the gradients are those of
    ``ref.ssd_scan_chunked``."""
    xh, dt, A, Bm, Cm, s0, dy, dT = _inputs(5, 2, 53, 2, 16, 8)
    base = [torch.from_numpy(a) for a in (xh * dt[..., None], dt * A, Bm, Cm, s0)]

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in base]
        y, st = fn(*ins[:4], chunk=16, initial_state=ins[4])
        return torch.autograd.grad([y, st], ins, [torch.from_numpy(dy), torch.from_numpy(dT)])
    ops.reset_launch_counts()
    got = grads(ops.ssd_scan)
    assert not any(ops.launch_counts().values())
    for g, e in zip(got, grads(ref.ssd_scan_chunked)):
        torch.testing.assert_close(g, e, rtol=0, atol=0)


def test_only_the_expert_parallel_moe_is_unported():
    """SSD blocks train on the card now: the only raise left names item 14."""
    assert set(transformer._ROADMAP) == {"a2a"}
