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

``ref.ssd_scan_bwd_tiled`` spells out the CUDA kernels of the redesign:
their passes, the 16-row strips of the causal triangle, the heads' sum taken
inside the products of dB and dC per group of heads, and every product as
3xTF32 (``ref.matmul_3xtf32``) with dcum's terms summed in fp64.  It is held
to 1e-4 of each gradient's largest entry against ``jax.vjp`` in fp64 and
against autograd at ragged lengths, and one TF32 pass in its place is shown
to miss that bar.  ``ssd_scan_bwd.plan`` is tested as K1's plan is: every
head in one group, the triangle's tiles each owned by one warp, shared
memory within an H100 block's at every shape the wrapper takes, and the
constants and formulas as the source has them.

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
    expect = ["p"] * 20 + ["i"] * 7 + ["ll"] * 10 + ["i", "p"]
    assert kinds == expect
    assert "fn.argtypes = [p] * 20 + [i] * 7 + [ll] * 10 + [i, p]" in (
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


# ---------------------------------------------------------------------------
# the redesign's plain arithmetic: triangle strips, head groups, 3xTF32
# ---------------------------------------------------------------------------

TILED_TOL = 1e-4    # of each gradient's largest entry, as on the card

# (T, chunk, N, P, initial state, final-state gradient): chunks of 16, 64 and
# 128, N from 4 to 128 (4 and 12 not multiples of the mma's 8 columns)
TILED_CASES = [(48, 16, 4, 16, True, True), (48, 16, 12, 32, False, False),
               (128, 64, 16, 16, True, False), (128, 64, 100, 32, False, True),
               (256, 128, 128, 16, True, True), (256, 128, 8, 48, False, False),
               (128, 128, 64, 64, True, False), (256, 64, 32, 16, False, True)]


def _rel_errs(got, exp):
    return [float(np.abs(np.asarray(g, np.float64) - e).max() / np.abs(e).max())
            for g, e in zip(got, exp)]


@pytest.mark.parametrize("group_heads", [None, 1, 2])
@pytest.mark.parametrize("T,chunk,N,P,carry,d_final", TILED_CASES)
def test_tiled_3xtf32_matches_jax_vjp(T, chunk, N, P, carry, d_final, group_heads):
    """The kernels' arithmetic (3xTF32 products over the triangle's strips,
    the heads summed inside dB's and dC's products in groups) holds every
    gradient within 1e-4 of its largest entry against ``jax.vjp`` of the
    reference in fp64."""
    xh, dt, A, Bm, Cm, s0, dy, dT = _inputs(T + N + P, 2, T, 3, P, N)
    xdt, dA = xh * dt[..., None], dt * A
    s0 = s0 if carry else None
    dT = dT if d_final else np.zeros_like(dT)
    with jax.enable_x64(True):
        exp = _jax_grads(xdt, dA, Bm, Cm, s0, dy, dT, chunk, jnp.float64)
    got = ref.ssd_scan_bwd_tiled(
        *(torch.from_numpy(a) for a in (xdt, dA, Bm, Cm, dy)), chunk=chunk,
        initial_state=None if s0 is None else torch.from_numpy(s0),
        d_final=torch.from_numpy(dT) if d_final else None, group_heads=group_heads)
    got = [g for g in got if g is not None]
    assert len(got) == len(exp) and all(g.dtype == torch.float32 for g in got)
    errs = _rel_errs([g.numpy() for g in got], exp)
    assert max(errs) <= TILED_TOL, dict(zip(("xdt", "dA", "B", "C", "initial_state"), errs))


@pytest.mark.parametrize("T,chunk,N", [(37, 16, 4), (130, 128, 12), (379, 128, 128),
                                       (100, 32, 8)])
def test_tiled_3xtf32_at_ragged_lengths(T, chunk, N):
    """A ragged last chunk: every gradient within 1e-4 of its largest entry
    against autograd through ``ref.ssd_scan_chunked``."""
    xh, dt, A, Bm, Cm, s0, dy, dT = _inputs(T + N, 2, T, 2, 16, N)
    ins = [torch.from_numpy(a).requires_grad_() for a in (xh * dt[..., None], dt * A, Bm, Cm, s0)]
    y, st = ref.ssd_scan_chunked(*ins[:4], chunk=chunk, initial_state=ins[4])
    exp = torch.autograd.grad([y, st], ins, [torch.from_numpy(dy), torch.from_numpy(dT)])
    got = ref.ssd_scan_bwd_tiled(*(x.detach() for x in ins[:4]), torch.from_numpy(dy),
                                 chunk=chunk, initial_state=ins[4].detach(),
                                 d_final=torch.from_numpy(dT))
    assert max(_rel_errs([g.numpy() for g in got], [e.numpy() for e in exp])) <= TILED_TOL


@pytest.mark.parametrize("chunk,N,P", [(32, 128, 64), (128, 4, 16)])
def test_tiled_3xtf32_at_one_position_without_a_state(chunk, N, P):
    """T = 1 without an initial state: dA enters nothing, so ddA is 0 in
    exact arithmetic and its rounding is held to 1e-4 of 1e-1 of the
    largest entry of all the gradients (as ``grad_scales`` in chip_smoke.py
    holds the kernel's); the others within 1e-4 of their own largest entry,
    against autograd through ``ref.ssd_scan_chunked`` in fp64."""
    xh, dt, A, Bm, Cm, _, dy, dT = _inputs(chunk + N, 2, 1, 3, P, N)
    ins = [torch.from_numpy(a).double().requires_grad_()
           for a in (xh * dt[..., None], dt * A, Bm, Cm)]
    y, st = ref.ssd_scan_chunked(*ins, chunk=chunk)
    exp = torch.autograd.grad([y, st], ins, [torch.from_numpy(dy).double(),
                                            torch.from_numpy(dT).double()])
    got = ref.ssd_scan_bwd_tiled(*(x.detach().float() for x in ins), torch.from_numpy(dy),
                                 chunk=chunk, d_final=torch.from_numpy(dT))[:4]
    top = max(float(e.abs().max()) for e in exp)
    assert float(exp[1].abs().max()) <= 1e-12 * top
    for name, g, e in zip(("xdt", "dA", "B", "C"), got, exp):
        scale = 1e-1 * top if name == "dA" else float(e.abs().max())
        assert float((g.double() - e).abs().max()) <= TILED_TOL * scale, name


def test_one_tf32_pass_does_not_hold_the_bar():
    """The same walk with one TF32 pass a product misses 1e-4 on some
    gradient: the small terms of 3xTF32 are what hold it."""
    T, chunk, N, P = 256, 128, 128, 16
    xh, dt, A, Bm, Cm, s0, dy, dT = _inputs(7, 2, T, 3, P, N)
    xdt, dA = xh * dt[..., None], dt * A
    with jax.enable_x64(True):
        exp = _jax_grads(xdt, dA, Bm, Cm, s0, dy, dT, chunk, jnp.float64)
    args = [torch.from_numpy(a) for a in (xdt, dA, Bm, Cm, dy)]
    kw = dict(chunk=chunk, initial_state=torch.from_numpy(s0), d_final=torch.from_numpy(dT))
    three = ref.ssd_scan_bwd_tiled(*args, **kw)
    one = ref.ssd_scan_bwd_tiled(*args, matmul=ref.matmul_tf32, **kw)
    assert max(_rel_errs([g.numpy() for g in three], exp)) <= TILED_TOL
    assert max(_rel_errs([g.numpy() for g in one], exp)) > TILED_TOL


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,N", [(4, 2048, 32, 128), (1, 512, 32, 128), (1, 8192, 32, 128),
                                     (2, 300, 4, 16), (1, 1, 1, 4), (2, 37, 3, 100),
                                     (1, 16, 7, 8)])
def test_plan_covers_every_head_once_in_groups(B, T, H, N):
    """Every head in exactly one group of ssd_bwd_bc, none empty; the blocks
    stay within one wave of an H100 where the heads can be cut, and there
    are partials only with more than one group."""
    p = bwd_mod.plan(B, T, H, 64, N, 128)
    groups = bwd_mod.head_groups(p, H)
    assert len(groups) == p.groups
    assert [h for h0, h1 in groups for h in range(h0, h1)] == list(range(H))
    assert all(h1 > h0 for h0, h1 in groups)
    blocks = p.halves * p.groups * p.chunks * B
    assert blocks <= max(bwd_mod.SMS, p.halves * p.chunks * B)
    assert (p.partial_floats == 0) == (p.groups == 1)
    assert p.halves == -(-p.n8 // bwd_mod.HALF) and p.n8 % 8 == 0 and p.n8 - N < 8


def test_plan_at_the_training_shape():
    """mamba2_370m's training shape: one group (128 blocks, no partials)."""
    p = bwd_mod.plan(4, 2048, 32, 64, 128, 128)
    assert (p.chunks, p.groups, p.halves, p.p_tile, p.p_slice) == (16, 1, 2, 64, 32)
    assert p.partial_floats == 0


@pytest.mark.parametrize("strips", range(1, 9))
def test_triangle_tiles_each_owned_by_one_warp(strips):
    """Every 16 x 8 tile of the causal triangle (strip r, column tiles
    below 2(r + 1)) is owned by exactly one warp; a warp's strips fit the
    kernel's slots (2 for the low strip, 4 for the high one), and with 8
    strips every warp owns 4 or 5 tiles."""
    owned = bwd_mod.tri_tiles(strips)
    flat = [tile for tiles in owned for tile in tiles]
    assert sorted(flat) == sorted((r, nt) for r in range(strips) for nt in range(2 * (r + 1)))
    for warp, tiles in enumerate(owned):
        lo, q = warp >> 2, warp & 3
        assert all(nt % 4 == q for _, nt in tiles)
        assert sum(1 for r, _ in tiles if r == lo) <= 2
        assert sum(1 for r, _ in tiles if r != lo) <= 4
    if strips == 8:
        assert {len(tiles) for tiles in owned} == {4, 5}


@pytest.mark.parametrize("chunk", range(16, 129, 16))
def test_plan_fits_shared_memory(chunk):
    """Each launch's shared memory fits an H100 block's 232,448 bytes at
    every shape the wrapper takes (chunk 16-128, N 4-128, P any multiple of
    16); ssd_bwd_chunk's leaves room for two blocks an SM."""
    for N in range(4, 129, 4):
        for P in (16, 32, 48, 64, 80, 96, 128, 256):
            p = bwd_mod.plan(1, 100, 2, P, N, chunk)
            assert max(p.chunk_smem, p.grads_smem, p.bc_smem) <= bwd_mod.SMEM_LIMIT
            assert 2 * p.chunk_smem <= 228 * 1024 - 2048
    assert bwd_mod.plan(4, 2048, 32, 64, 128, 128).grads_smem == 227456


def test_plan_agrees_with_the_source():
    """The constants and the shared-memory formulas of ``plan`` are the
    source's own."""
    source = (KERNELS / "csrc" / "ssd_scan_bwd.cu").read_text()
    tile = (KERNELS / "csrc" / "ssd_tile.cuh").read_text()
    assert f"constexpr int kThreads = {bwd_mod.THREADS};" in tile
    assert f"constexpr int kWide = {bwd_mod.WIDE};" in source
    assert f"constexpr int kHalf = {bwd_mod.HALF};" in source
    assert f"constexpr int kParts = {bwd_mod.PARTS};" in source
    assert f"constexpr int kSmemLimit = {bwd_mod.SMEM_LIMIT};" in source
    assert "return 12 * Q + 4 * imax((imin(Q, 64) + Q) * (N8 + 4), Q * (N8 + 8) + Q * (PT + 8));" \
        in source
    assert "return imax(Q * (Q + 4), (Q + N8) * (PT + 4));" in source
    assert ("return 16 * Q + 8 * (kParts * Q + kWideWarps) +\n"
            "         4 * (region0(Q, N8, PT) + Q * (PT + 4) + Q * (imax(PT, N8) + 4) + N8 * (PT + 8));"
            ) in source
    assert "return 2 * Q * (PS + 4) + 2 * HW * (PS + 4) + 4 * Q;" in source
    assert "return 4 * (Q * (Q + 4) + imax(2 * ring_stage(Q, PS, HW), 2 * Q * (HW + 8)));" \
        in source
    assert "return P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : 16;" in source
    assert "return P % 32 == 0 ? 32 : 16;" in source
    for P in range(16, 513, 16):
        assert bwd_mod.col_tile(P) == (64 if P % 64 == 0 else 32 if P % 32 == 0 else 16)
        assert bwd_mod.slice_width(P) == (32 if P % 32 == 0 else 16)
    # the SIMT product path is gone, and no kernel uses atomics
    assert "gemm(" not in source and "mma_slice" not in source
    assert re.search(r"\batomic\w*\(", source) is None
    assert source.count("MF::mma_pass(") >= 4 and "mma_tf32" not in source
    # the tiles a warp owns of strip r, as tri_tiles counts them
    assert "return imax(0, (2 * r + 5 - q) / 4);" in source
    for strips in range(1, 9):
        for warp, tiles in enumerate(bwd_mod.tri_tiles(strips)):
            for r in {r for r, _ in tiles}:
                assert sum(1 for rr, _ in tiles if rr == r) == max(0, (2 * r + 5 - (warp & 3)) // 4)
