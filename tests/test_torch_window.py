"""The sliding window on the CPU: K2's plain versions and the windowed model.

* ``ref.paged_attention_ref(window=)`` and ``ref.paged_attention_split(
  window=)`` (K2's split and merge in plain PyTorch) against the dense
  masked attention of the JAX package, ``repro.models.layers.attention``
  with ``causal_mask(window=)``, for a query at ``context_len - 1``: windows
  of 1, page − 1, page and one longer than every context, contexts on both
  sides of a partition edge, scattered tables.  2e-4 in fp32 (the
  reference's kernel tolerance).
* Reduced ``mixtral_8x7b`` (window 64): a 150-token prompt in chunks of 40
  and 110, then 40 decodes past the window, in the port's linear cache,
  against the JAX model on its ring cache with a ``window_slack`` of the
  longest chunk, which keeps a chunk's writes off the keys its first
  queries still see.  2e-3 on logits, the reference's tolerance.
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
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as paged_mod
from repro_torch.kernels import ref as tref
from repro_torch.models.convert import from_numpy
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)    # the suite runs in several workers at once

PAGE, PPS = 16, 12          # 192 keys a table row
PART = paged_mod.PARTITION
LENS = [1, PAGE - 1, PART - 1, PART, PART + 1, 2 * PART + 3, PPS * PAGE]


def _dense_windowed(q, k_pages, v_pages, tables, lens, window):
    """The JAX package's dense attention over each gathered context, one
    query at position len − 1, masked by ``causal_mask(window=)``."""
    B = q.shape[0]
    S = tables.shape[1] * PAGE
    k = k_pages[tables].reshape(B, S, *k_pages.shape[2:])
    v = v_pages[tables].reshape(B, S, *v_pages.shape[2:])
    kv_pos = np.where(np.arange(S)[None, :] < lens[:, None], np.arange(S)[None, :], -1)
    q_pos = (lens - 1)[:, None]
    mask = JL.causal_mask(jnp.asarray(q_pos, jnp.int32), jnp.asarray(kv_pos, jnp.int32),
                          window)
    out = JL.attention(jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v), mask)
    return np.asarray(out)[:, 0]


@pytest.mark.parametrize("window", [1, PAGE - 1, PAGE, PART + 7, 10 * PPS * PAGE])
@pytest.mark.parametrize("G", [1, 4])
def test_paged_window_matches_dense_masked_attention(window, G):
    Hkv, D = 2, 32
    B = len(LENS)
    rng = np.random.default_rng(window * 10 + G)
    num_pages = B * PPS + 5
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    kp = rng.standard_normal((num_pages, PAGE, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((num_pages, PAGE, Hkv, D)).astype(np.float32)
    tables = rng.permutation(num_pages)[:B * PPS].reshape(B, PPS).astype(np.int32)
    lens = np.asarray(LENS, np.int32)
    exp = _dense_windowed(q, kp, vp, tables, lens, window)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    np.testing.assert_allclose(tref.paged_attention_ref(*args, window=window).numpy(), exp,
                               rtol=2e-4, atol=2e-4)
    for partition in (PAGE, PART):
        np.testing.assert_allclose(
            tref.paged_attention_split(*args, window=window, partition=partition).numpy(),
            exp, rtol=2e-4, atol=2e-4)
    # the dispatch sends CPU tensors to the plain version, window and all
    assert torch.equal(ops.paged_attention(*args, window=window),
                       tref.paged_attention_ref(*args, window=window))


def test_paged_window_empties_the_partitions_before_it():
    """With a window, K2's first pass leaves every partition that ends at or
    before ``context_len - window`` empty (m = −inf, l = 0), as the kernel's
    blocks that exit at once."""
    B, Hq, Hkv, D = 1, 2, 1, 32
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((PPS, PAGE, Hkv, D)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((PPS, PAGE, Hkv, D)).astype(np.float32))
    tables = torch.arange(PPS, dtype=torch.int32)[None]
    lens = torch.tensor([PPS * PAGE], dtype=torch.int32)        # 192 keys, 3 partitions
    m, l, _ = tref.paged_attention_partials(q, kp, vp, tables, lens, window=PART)
    assert torch.isinf(m[0, :, :2]).all() and (l[0, :, :2] == 0).all()
    assert torch.isfinite(m[0, :, 2]).all()
    m, l, _ = tref.paged_attention_partials(q, kp, vp, tables, lens, window=PART + 1)
    assert torch.isinf(m[0, :, 0]).all() and torch.isfinite(m[0, :, 1:]).all()


def test_paged_wrapper_rejects_cpu_tensors_with_a_window():
    t = torch.zeros((1, 2, 32))
    pages = torch.zeros((1, PAGE, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_mod.paged_attention(t, pages, pages, torch.zeros((1, 1), dtype=torch.int32),
                                  torch.ones(1, dtype=torch.int32), window=4)


def test_mixtral_window_chunks_and_decodes_match_jax():
    arch = "mixtral_8x7b"
    cfg = jax_reduced_config(arch)
    window = cfg.sliding_window
    assert window == 64
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.key(6), jnp.float32)
    tm = build_model(get_reduced_config(arch))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, (1, 150))
    chunks = [(0, 40), (40, 150)]
    n_dec = 40

    jc = jm.init_cache(1, 256, jnp.float32, window_slack=110)
    assert jc["layers"]["k"].shape[2] == window + 110          # a ring, not the context
    tc = tm.init_cache(1, 192, torch.float32, "cpu")
    for a, b in chunks:
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt[:, a:b])}, jc)
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt[:, a:b])}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3, atol=2e-3)
    nxt = rng.integers(0, cfg.vocab_size, (n_dec, 1, 1))
    for i in range(n_dec):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt[i]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt[i]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3, atol=2e-3,
                                   err_msg=f"decode {i} at position {150 + i}")
    assert tc["cache_len"].tolist() == [150 + n_dec]
    # the window matters here: without it the same cache gives other logits
    plain = build_model(get_reduced_config(arch).replace(sliding_window=None))
    wide, _ = plain.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                            plain.init_cache(1, 192, torch.float32, "cpu"))
    ref_full, _ = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                             tm.init_cache(1, 192, torch.float32, "cpu"))
    assert float((wide - ref_full).abs().max()) > 1e-3
