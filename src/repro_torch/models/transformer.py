"""Dense decoder LM in PyTorch: the uniform-``attn`` path of
``repro.models.transformer.TransformerLM``.

Entry points, as in the reference:

* ``prefill(params, inputs, cache)``  — process T new tokens per sequence
  against the cache; returns the last position's logits.
* ``decode_step(params, cache, tokens)`` — the T = 1 case.
* ``decode_slots(params, cache, tokens, slots)`` — T = 1 for the listed cache
  rows only; no other row is read or written.  The serving runner decodes
  the sequences of a step this way, so a slot that is mid-prefill is never
  touched by another request's decode.

Parameters are nested dictionaries of tensors with the JAX names and layouts,
blocks stacked on a leading layer axis.  The cache keeps the reference's
layout: ``k``/``v`` (L, B, S, Hkv, D), ``kv_pos`` (L, B, S) filled with −1, and
``cache_len`` (B,).  **The cache is updated in place**: ``prefill`` and the
decodes write the new K/V, positions and lengths into the tensors they were
given and return that same cache.

Attention over the cache goes through :mod:`repro_torch.kernels.ops`:

* T > 1: flash attention (K1) over ``k[:, :cache_len + T]``; the queries are
  the last T of those keys, K1's bottom-right alignment.  The rows of a batch
  must share one ``cache_len``.
* T = 1: paged attention (K2) reads the slot cache as pages: a row of S
  positions is S / PAGE_SIZE consecutive pages, so row b's block table is
  ``b * S / PAGE_SIZE + arange(S / PAGE_SIZE)`` and its context length is
  position + 1.  The pages are a view of the cache, not a copy.

Anything else of the reference (sliding windows, ``local_attn``, MoE, SSD,
RG-LRU, encoder-decoder, frontends, ``kv_append="defer"``, the training loss)
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops

from . import layers as L
from .config import ModelConfig

PAGE_SIZE = 16     # K2's view of a slot: S / PAGE_SIZE consecutive pages

_ROADMAP = {
    "sliding_window": "ROADMAP Queue A item 8 (sliding window and MoE)",
    "local_attn": "ROADMAP Queue A item 8 (sliding window and MoE)",
    "moe": "ROADMAP Queue A item 8 (sliding window and MoE)",
    "defer": "ROADMAP Queue A item 9 (deferred KV append)",
    "ssd": "ROADMAP Queue A item 10 (Mamba2 / SSD)",
    "rglru": "ROADMAP Queue A item 11 (RG-LRU and mixed layer patterns)",
    "encoder": "ROADMAP Queue A item 12 (Whisper encoder-decoder)",
    "frontend": "ROADMAP Queue A item 8 (llava's frontend embeddings)",
    "train": "ROADMAP Queue A item 13 (training)",
}


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} does not run in the PyTorch port yet: "
                               f"{_ROADMAP[what]}")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any part of ``cfg`` the port does not run yet."""
    for kind in cfg.layer_pattern:
        if kind != "attn":
            raise _unported(kind)
    if cfg.sliding_window is not None:
        raise _unported("sliding_window")
    if cfg.moe is not None:
        raise _unported("moe")
    if cfg.encoder is not None:
        raise _unported("encoder")
    if cfg.frontend is not None:
        raise _unported("frontend")
    if cfg.kv_append != "inline":
        raise _unported("defer")


# ==========================================================================
# per-block parameter init / apply
# ==========================================================================

def block_params(cfg: ModelConfig, kind: str, generator: torch.Generator, dtype,
                 device=None, lead=()) -> Dict:
    """One block's parameters; ``lead=(L,)`` stacks L blocks on axis 0."""
    if kind != "attn":
        raise _unported(kind)
    if cfg.moe is not None:
        raise _unported("moe")
    return {
        "norm1": L.norm_params(cfg, dtype, device, lead),
        "attn": L.attn_params(cfg, generator, dtype, device, lead),
        "norm2": L.norm_params(cfg, dtype, device, lead),
        "mlp": L.mlp_params(cfg, generator, dtype, device, lead=lead),
    }


def block_cache(cfg: ModelConfig, kind: str, batch: int, cache_size: int, dtype,
                device=None, lead=()) -> Dict:
    """Cache leaves of one block; ``lead=(L,)`` stacks L blocks on axis 0."""
    if kind != "attn":
        raise _unported(kind)
    if cfg.sliding_window is not None:
        raise _unported("sliding_window")
    shape = tuple(lead) + (batch, cache_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kv_pos": torch.full(shape[:-2], -1, dtype=torch.int32, device=device)}


@dataclass
class CacheStep:
    """Where one forward's tokens go in the cache, worked out once for all
    layers.  Prefill (T > 1) sets ``start``; decode (T = 1) sets the rest."""

    start: Optional[int] = None                  # first position of every row
    rows: Optional[torch.Tensor] = None          # (n,) cache rows decoded
    block_tables: Optional[torch.Tensor] = None  # (n, S / PAGE_SIZE) int32
    context_lens: Optional[torch.Tensor] = None  # (n,) int32


def run_block(cfg: ModelConfig, kind: str, p: Dict, x, positions, cache: Optional[Dict],
              *, step: CacheStep, force: Optional[str] = None):
    """One residual block over its layer's cache (updated in place).

    x: (n, T, d); positions: (n, T); cache: {"k", "v": (B, S, Hkv, D),
    "kv_pos": (B, S)}.  Returns y (n, T, d)."""
    if kind != "attn":
        raise _unported(kind)
    if cache is None:
        raise _unported("train")
    h = L.apply_norm(cfg, x, p["norm1"])
    q, k_new, v_new = L.attn_qkv(cfg, p["attn"], h, positions)
    k_c, v_c, kv_pos = cache["k"], cache["v"], cache["kv_pos"]
    q = q.to(k_c.dtype)
    T = positions.shape[1]
    if step.start is not None:
        s0, s1 = step.start, step.start + T
        k_c[:, s0:s1] = k_new.to(k_c.dtype)
        v_c[:, s0:s1] = v_new.to(v_c.dtype)
        kv_pos[:, s0:s1] = positions.to(kv_pos.dtype)
        ctx = ops.flash_attention(q, k_c[:, :s1], v_c[:, :s1], causal=True,
                                  force=force)
    else:
        rows, pos = step.rows, positions[:, 0].long()
        k_c[rows, pos] = k_new[:, 0].to(k_c.dtype)
        v_c[rows, pos] = v_new[:, 0].to(v_c.dtype)
        kv_pos[rows, pos] = pos.to(kv_pos.dtype)
        page_shape = (-1, PAGE_SIZE) + tuple(k_c.shape[2:])
        ctx = ops.paged_attention(
            q[:, 0].contiguous(), k_c.view(page_shape), v_c.view(page_shape),
            step.block_tables, step.context_lens, force=force)[:, None]
    x = x + L.attn_out(p["attn"], ctx.to(x.dtype))
    h2 = L.apply_norm(cfg, x, p["norm2"])
    return x + L.mlp(cfg, p["mlp"], h2)


def _layer(tree, i: int):
    """The i-th layer's view of a tree of stacked (L, ...) tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ==========================================================================
# decoder-only LM
# ==========================================================================

class TransformerLM:
    """Dense decoder LM over a uniform ``attn`` layer pattern."""

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg
        self.uniform = "attn"

    # ------------------------------------------------------------- params --
    def init(self, generator: Optional[torch.Generator] = None,
             dtype=torch.float32, device=None) -> Dict[str, Any]:
        """Random parameters on ``generator``'s device (``cuda`` when no
        generator is given: a fresh one seeded with 0)."""
        if generator is None:
            generator = torch.Generator(resolve_device(device)).manual_seed(0)
        device = generator.device
        cfg = self.cfg
        params: Dict[str, Any] = {
            "embed": L.embed_init((cfg.vocab_size, cfg.d_model), generator,
                                  dtype=dtype, device=device),
            "final_norm": L.norm_params(cfg, dtype, device),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = L.dense_init((cfg.d_model, cfg.vocab_size), generator,
                                             dtype=dtype, device=device)
        params["blocks"] = block_params(cfg, self.uniform, generator, dtype, device,
                                        lead=(cfg.num_layers,))
        return params

    # -------------------------------------------------------------- embed --
    def _embed_inputs(self, params, inputs):
        extra = set(inputs) - {"tokens"}
        if "frontend_embeds" in extra:
            raise _unported("frontend")
        if extra:
            raise ValueError(f"unsupported inputs {sorted(extra)}: positions "
                             "always follow the cache length")
        return params["embed"][inputs["tokens"]]

    def _unembed(self, params, x):
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return x @ w

    # --------------------------------------------------------------- body --
    def _run(self, params, x, positions, cache, step: CacheStep, force):
        cfg = self.cfg
        for i in range(cfg.num_layers):
            x = run_block(cfg, self.uniform, _layer(params["blocks"], i), x, positions,
                          _layer(cache["layers"], i), step=step, force=force)
        x = L.apply_norm(cfg, x[:, -1:, :], params["final_norm"])
        return self._unembed(params, x)[:, 0, :]

    # ----------------------------------------------------------- serving --
    def init_cache(self, batch: int, cache_size: int, dtype=torch.bfloat16,
                   device=None) -> Dict[str, Any]:
        """An empty cache of ``batch`` rows of ``cache_size`` positions, a
        multiple of PAGE_SIZE (``cuda`` unless ``device`` says otherwise)."""
        if cache_size % PAGE_SIZE:
            raise ValueError(f"cache_size {cache_size} must be a multiple of "
                             f"the page size {PAGE_SIZE}")
        device = resolve_device(device)
        cfg = self.cfg
        return {"layers": block_cache(cfg, self.uniform, batch, cache_size, dtype,
                                      device, lead=(cfg.num_layers,)),
                "cache_len": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def prefill(self, params, inputs, cache, *, force: Optional[str] = None):
        """Extend every row of ``cache`` (in place) with T new tokens at
        positions cache_len + arange(T); returns (last-position logits (B, V),
        the same cache).  ``force="plain"`` runs the plain attention on the
        card."""
        tokens = inputs["tokens"]
        x = self._embed_inputs(params, inputs)
        B, T = tokens.shape
        if T == 1:
            rows = torch.arange(B, device=tokens.device)
            return self.decode_slots(params, cache, tokens, rows, force=force), cache
        starts = set(cache["cache_len"].tolist())
        if len(starts) != 1:
            raise ValueError(f"prefill of T={T} needs one cache_len for every row, "
                             f"got {sorted(starts)}")
        start = starts.pop()
        S = cache["layers"]["k"].shape[2]
        if start + T > S:
            raise ValueError(f"prefill to position {start + T} overflows the "
                             f"cache of {S} positions")
        positions = (start + torch.arange(T, device=tokens.device)).expand(B, T)
        logits = self._run(params, x, positions, cache, CacheStep(start=start), force)
        cache["cache_len"] += T
        return logits, cache

    def decode_step(self, params, cache, tokens, *, force: Optional[str] = None):
        """tokens: (B, 1) -> (logits (B, V), the same cache, updated)."""
        return self.prefill(params, {"tokens": tokens}, cache, force=force)

    def decode_slots(self, params, cache, tokens, slots, *,
                     force: Optional[str] = None):
        """Decode one token for each cache row in ``slots`` and no other.

        tokens: (n, 1); slots: (n,) row indices; each token goes at its row's
        ``cache_len``, which then grows by one (in place).  Returns logits
        (n, V)."""
        kv = cache["layers"]["k"]
        B, S = kv.shape[1], kv.shape[2]
        rows = torch.as_tensor(slots, device=tokens.device).long()
        positions = cache["cache_len"][rows].long()[:, None]
        tables = torch.arange(B * S // PAGE_SIZE, dtype=torch.int32,
                              device=tokens.device).view(B, S // PAGE_SIZE)
        step = CacheStep(rows=rows, block_tables=tables[rows].contiguous(),
                         context_lens=(positions[:, 0] + 1).int())
        x = params["embed"][tokens]
        logits = self._run(params, x, positions, cache, step, force)
        cache["cache_len"][rows] += 1
        return logits


def build_model(cfg: ModelConfig) -> TransformerLM:
    if cfg.is_enc_dec:
        raise _unported("encoder")
    return TransformerLM(cfg)
