"""``kv_append="defer"`` in the port against the JAX package on the CPU.

The reference (``repro.models.transformer``, ``kv_append="defer"``) attends
over [stale cache ‖ new chunk] as two ``attention_partial`` segments merged
by ``attention_merge2``, and writes every layer's new K/V once after the
stack.  The port runs the same two segments through K1 (``q_offset`` and
``return_lse``) and K2 (``return_lse``); on the CPU their plain versions.
Held here:

* the plain K1 with ``q_offset``/lse, the plain K2 with lse and K1's tiled
  decomposition against JAX ``attention_partial`` over explicit positions
  (``causal_mask``), and the merge against ``attention_merge2``, at 2e-4 in
  fp32; windows of 1, rows that see no key, a chunk at s0 = 0;
* the four archs of ``tests/test_kv_defer.py`` (reduced): the port's defer
  logits against the JAX defer logits and the port's inline ones at 2e-3,
  the caches after the write against the port's inline cache and the JAX
  defer cache at 2e-4;
* real-mode serving of reduced ``qwen2_5_3b`` with ``defer`` against greedy
  JAX decoding, as ``tests/test_torch_serving.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models.convert import from_numpy
from repro_torch.models.transformer import build_model
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.serving.stack import build_stack

torch.set_num_threads(2)    # the suite runs in several workers at once

ARCHS = ["qwen2_5_3b", "mixtral_8x7b", "recurrentgemma_2b", "olmo_1b"]
KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
CACHE_TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_segment(q, k, v, q_pos, kv_pos, window):
    """JAX ``attention_partial`` over explicit positions, as (out, lse,
    seen): out = acc / l and lse = m + log l on the rows that see a key."""
    B, T = q.shape[:2]
    mask = JL.causal_mask(jnp.broadcast_to(jnp.asarray(q_pos), (B, T)),
                          jnp.broadcast_to(jnp.asarray(kv_pos), (B, k.shape[1])), window)
    acc, m, l = JL.attention_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask)
    seen = np.asarray(mask.any(axis=-1))                      # (B, T)
    out = np.asarray(acc) / np.asarray(l)[..., None]
    lse = np.asarray(m) + np.log(np.asarray(l))
    return out, lse, seen


def _check_segment(out, lse, exp_out, exp_lse, seen):
    """(out, lse) of the port against JAX's on the rows that see a key; the
    others give 0 and -inf."""
    out, lse = out.numpy(), lse.numpy()
    np.testing.assert_allclose(out[seen], exp_out[seen], **KERNEL_TOL)
    np.testing.assert_allclose(lse[seen], exp_lse[seen], **KERNEL_TOL)
    assert (out[~seen] == 0).all()
    assert np.isneginf(lse[~seen]).all()


# (B, T, S, Hq, Hkv, D, q_offset, window): the cache segment (q_offset = S)
# with windows that leave rows empty or every row empty (window 1), the new
# chunk's segment at s0 = 0 (q_offset 0, S = T), an offset in between, and
# the default (q_offset None: S - T)
K1_CASES = [(2, 5, 12, 4, 2, 16, 12, None), (2, 5, 12, 4, 2, 16, 12, 3),
            (1, 6, 9, 4, 1, 16, 9, 1), (2, 7, 7, 4, 2, 16, 0, 4), (1, 7, 7, 2, 2, 16, 0, 1),
            (1, 4, 10, 4, 2, 16, 3, 2), (2, 6, 11, 6, 2, 32, None, 5),
            (1, 70, 150, 8, 2, 32, 150, 100), (1, 70, 70, 8, 2, 32, 0, 20)]


@pytest.mark.parametrize("case", K1_CASES)
def test_flash_segment_matches_jax_attention_partial(case):
    B, T, S, Hq, Hkv, D, q_offset, window = case
    rng = np.random.default_rng(sum(case[:6]))
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    off = S - T if q_offset is None else q_offset
    exp_out, exp_lse, seen = _jax_segment(q, k, v, off + np.arange(T)[None], np.arange(S)[None],
                                          window)
    out, lse = tref.flash_attention_ref(_t(q), _t(k), _t(v), window=window, q_offset=q_offset,
                                        return_lse=True)
    _check_segment(out, lse, exp_out, exp_lse, seen)
    if D in flash_mod.HEAD_DIMS:
        # the bf16 kernel's tiling and statistics, here on fp32 inputs
        for rows, keys in flash_mod.TILES:
            out, lse = tref.flash_attention_tiled(_t(q), _t(k), _t(v), window=window,
                                                  q_offset=q_offset, return_lse=True,
                                                  block_rows=rows, block_keys=keys)
            _check_segment(out, lse, exp_out, exp_lse, seen)
    kw = dict(window=window, q_offset=q_offset)
    np.testing.assert_array_equal(
        tref.flash_attention_ref(_t(q), _t(k), _t(v), **kw).numpy(),
        tref.flash_attention_ref(_t(q), _t(k), _t(v), return_lse=True, **kw)[0].numpy())


def test_kv_tile_range_follows_q_offset():
    """The cache segment's tiles: from the window's start (in whole tiles)
    to S, and none when the window starts at or past S."""
    assert flash_mod.kv_tile_range(0, 64, 64, 1000, 64, True, None, 1000) == (0, 16)
    assert flash_mod.kv_tile_range(128, 64, 512, 1024, 64, True, 100, 1024) == (16, 16)
    assert flash_mod.kv_tile_range(0, 64, 512, 1024, 64, True, 100, 1024) == (14, 16)
    assert flash_mod.kv_tile_range(0, 64, 512, 1024, 64, True, 100, None) == (6, 9)


@pytest.mark.parametrize("window", [None, 1, 2, 9, 40])
@pytest.mark.parametrize("Hq,Hkv,D", [(4, 2, 16), (10, 1, 32)])
def test_paged_segment_matches_jax_attention_partial(window, Hq, Hkv, D):
    """K2's plain version and its split-and-merge with the lse: the decode's
    cache segment (context_lens = pos, window - 1), an empty context among
    the contexts."""
    rng = np.random.default_rng(Hq + D + (window or 0))
    B, page, pps = 5, 8, 8
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((B * pps + 1, page, Hkv, D)).astype(np.float32)
              for _ in range(2))
    tables = rng.permutation(B * pps + 1)[:B * pps].reshape(B, pps).astype(np.int32)
    pos = np.array([0, 1, 7, 30, 64], dtype=np.int32)           # the new token's position
    k, v = (p[tables].reshape(B, pps * page, Hkv, D) for p in (kp, vp))
    # the reference's cache segment: the slots before pos hold their
    # positions, the rest are unwritten (-1); the query sits at pos
    slots = np.arange(pps * page)[None]
    kv_pos = np.where(slots < pos[:, None], slots, -1)
    exp_out, exp_lse, seen = _jax_segment(q[:, None], k, v, pos[:, None], kv_pos, window)
    w = None if window is None else window - 1
    args = (_t(q), _t(kp), _t(vp), _t(tables), _t(pos))
    if w == 0:
        assert not seen.any()        # the caller skips this segment at a window of 1
        return
    split, split_lse = tref.paged_attention_split(*args, window=w, return_lse=True)
    _check_segment(split[:, None], split_lse[:, None], exp_out, exp_lse, seen)
    # the plain version gives the mean of V for an empty context, as the JAX
    # package's does; its lse is -inf there, so a merge weighs it 0
    out, lse = tref.paged_attention_ref(*args, window=w, return_lse=True)
    out = torch.where(torch.tensor(seen[:, 0])[:, None, None], out, 0.0)
    _check_segment(out[:, None], lse[:, None], exp_out, exp_lse, seen)


def test_merge_matches_jax_attention_merge2():
    """Two segments of one attention, merged (``attention_merge``), against
    the JAX merge of the reference's segments and against the attention over both at once;
    a segment that sees no key weighs 0."""
    rng = np.random.default_rng(7)
    B, T, S, Hq, Hkv, D, window = 2, 6, 10, 4, 2, 16, 8
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S + T, Hkv, D)).astype(np.float32) for _ in range(2))
    q_pos = S + np.arange(T)[None]
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    segs = []
    for lo, hi in ((0, S), (S, S + T)):
        mask = JL.causal_mask(jnp.asarray(np.repeat(q_pos, B, 0)),
                              jnp.asarray(np.repeat(np.arange(lo, hi)[None], B, 0)), window)
        segs.append(JL.attention_partial(jq, jk[:, lo:hi], jv[:, lo:hi], mask))
    exp = np.asarray(JL.attention_merge2(segs[0], segs[1], jnp.float32))
    tq, tk, tv = _t(q), _t(k), _t(v)
    cache = TL.attention_partial(tq, tk[:, :S], tv[:, :S], q_offset=S, window=window)
    new = TL.attention_partial(tq, tk[:, S:], tv[:, S:], window=window)
    got = TL.attention_merge([cache, new], torch.float32)
    np.testing.assert_allclose(got.numpy(), exp, **KERNEL_TOL)
    whole = tref.flash_attention_ref(tq, tk, tv, window=window)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **KERNEL_TOL)
    empty = (torch.zeros_like(new[0]), torch.full_like(new[1], -torch.inf))
    np.testing.assert_array_equal(TL.attention_merge([empty, new], torch.float32).numpy(),
                                  new[0].numpy())
    both_empty = TL.attention_merge([empty, empty], torch.float32)
    assert (both_empty == 0).all()


def _leaves(tree, prefix=""):
    """(dotted name, leaf) of a cache tree, dicts in key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}.{key}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def _run(model, params, toks, cache, prefill, decode):
    """The reference test's traffic: two prefill chunks, then four decodes."""
    T = 12
    logits = []
    l1, cache = prefill(params, {"tokens": toks[:, :T // 2]}, cache)
    l2, cache = prefill(params, {"tokens": toks[:, T // 2:T]}, cache)
    logits += [l1, l2]
    for t in range(T, T + 4):
        lt, cache = decode(params, cache, toks[:, t:t + 1])
        logits.append(lt)
    return logits, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_defer_matches_jax_defer_and_inline(arch):
    cfg = jax_reduced_config(arch)
    jm = jax_build_model(cfg.replace(kv_append="defer"))
    jp = jm.init(jax.random.key(0), jnp.float32)
    toks = np.asarray(jax.random.randint(jax.random.key(0), (2, 16), 0, cfg.vocab_size))
    jlogits, jcache = _run(jm, jp, jnp.asarray(toks), jm.init_cache(2, 64, jnp.float32),
                           jm.prefill, jm.decode_step)

    params = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    runs = {}
    for mode in ("defer", "inline"):
        tm = build_model(get_reduced_config(arch).replace(kv_append=mode))
        assert tm.cfg.kv_append == mode
        runs[mode] = _run(tm, params, _t(toks), tm.init_cache(2, 64, torch.float32, "cpu"),
                          tm.prefill, tm.decode_step)
    for got, exp, ref_inline in zip(runs["defer"][0], jlogits, runs["inline"][0]):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **LOGIT_TOL)
        np.testing.assert_allclose(got.numpy(), ref_inline.numpy(), **LOGIT_TOL)
    # the caches after the deferred write: equal to the inline ones, and the
    # attention layers' to the JAX defer cache (its ring of 64 = the window
    # is the port's linear cache of 64 here)
    defer, inline = dict(_leaves(runs["defer"][1])), dict(_leaves(runs["inline"][1]))
    assert defer.keys() == inline.keys()
    for name, leaf in defer.items():
        np.testing.assert_allclose(leaf.float().numpy(), inline[name].float().numpy(),
                                   **CACHE_TOL, err_msg=name)
    jleaves = dict(_leaves(jax.tree.map(np.asarray, jcache)))
    compared = 0
    for name, leaf in defer.items():
        if name.rsplit(".", 1)[-1] in ("k", "v", "kv_pos") and name in jleaves:
            np.testing.assert_allclose(leaf.float().numpy(), jleaves[name].astype(np.float32),
                                       **CACHE_TOL, err_msg=name)
            compared += 1
    attn_layers = sum(k in ("attn", "local_attn") for k in cfg.layer_pattern)
    assert compared == (3 if len(set(cfg.layer_pattern)) == 1 else 3 * attn_layers)


@pytest.mark.parametrize("window", [1, 2, 5])
def test_defer_matches_inline_at_small_windows(window):
    """Windows of 1 (neither segment of the cache is read: the prefill's
    cache segment and the decode's K2 are skipped) and of a few keys, where
    the cache segment's rows past the window see no key; reduced mixtral.
    The JAX ring of ``window`` slots cannot hold a 6-token chunk, so the
    yardstick is the port's inline append, held against JAX in
    ``tests/test_torch_window.py``.  Both keep a ring of one page: the
    window and the slack to a whole page."""
    cfg = get_reduced_config("mixtral_8x7b").replace(sliding_window=window)
    m_in, m_df = build_model(cfg), build_model(cfg.replace(kv_append="defer"))
    params = m_in.init(torch.Generator().manual_seed(3), torch.float32, "cpu")
    toks = _t(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)))
    slack = 16 - window
    got = _run(m_df, params, toks, m_df.init_cache(2, 64, torch.float32, "cpu", slack),
               m_df.prefill, m_df.decode_step)
    exp = _run(m_in, params, toks, m_in.init_cache(2, 64, torch.float32, "cpu", slack),
               m_in.prefill, m_in.decode_step)
    for a, b in zip(got[0], exp[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGIT_TOL)
    for (name, a), (_, b) in zip(_leaves(got[1]), _leaves(exp[1])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **CACHE_TOL,
                                   err_msg=name)


ARCH = "qwen2_5_3b"
MAX_LEN = 128
WORKLOAD = [(24, 5), (37, 4), (50, 1), (29, 6)]    # (prompt length, max_new_tokens)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def greedy():
    cfg = jax_reduced_config(ARCH).replace(kv_append="defer")
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(19), jnp.float32)
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in WORKLOAD]
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    streams = []
    for prompt, (_, max_new) in zip(prompts, WORKLOAD):
        cache = jm.init_cache(1, MAX_LEN, jnp.float32)
        logits, cache = prefill(jp, {"tokens": jnp.asarray([prompt])}, cache)
        out = []
        while True:
            row = np.sort(np.asarray(logits[0]))
            assert row[-1] - row[-2] > MARGIN, "near-tie in the JAX stream"
            out.append(int(jnp.argmax(logits[0])))
            if len(out) == max_new:
                break
            logits, cache = decode(jp, cache, jnp.asarray([[out[-1]]]))
        streams.append(out)
    return from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), prompts, streams


@pytest.mark.timeout(300)
@pytest.mark.parametrize("policy", ["vllm", "sglang"])
def test_real_engine_with_defer_matches_greedy_jax(greedy, policy):
    params, prompts, streams = greedy
    cfg = get_reduced_config(ARCH).replace(kv_append="defer")
    engine_cfg = EngineConfig(policy=policy, max_num_seqs=4, max_batched_tokens=48,
                              block_size=4, num_blocks=512, chip="h100-sxm")
    stack = build_stack(cfg, engine_cfg, "real", model=build_model(cfg), params=params,
                        max_len=MAX_LEN, device="cpu", dtype=torch.float32)
    reqs = [Request(prompt_tokens=p, max_new_tokens=n) for p, (_, n) in zip(prompts, WORKLOAD)]
    try:
        stack.engine.start()
        stack.engine.submit_many(reqs)
        assert stack.engine.wait_until_complete(len(reqs), timeout=240)
    finally:
        stack.shutdown()
    for req, expected in zip(reqs, streams):
        assert req.output_tokens == expected, (req.prompt_len, req.output_tokens, expected)
    assert stack.runner.num_free_slots == 4
