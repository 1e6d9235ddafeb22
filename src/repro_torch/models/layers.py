"""Model building blocks in PyTorch: the dense subset of ``repro.models.layers``.

Plain functions over explicit parameter dictionaries that keep the JAX
package's names and layouts (attention weights (d, H, Dh) and (H, Dh, d)), so
that :mod:`repro_torch.models.convert` copies parameters without renaming or
transposing.  Compute runs in the input type with fp32 norms, RoPE and
softmax, as in the reference.

Conventions: B batch, T query tokens, S KV length, H heads, Hkv KV heads,
D head_dim, d = d_model, F = d_ff.

:func:`attention` and :func:`causal_mask` are the reference's dense,
mask-based attention, kept for layer-level parity tests; the model attends
over its cache through :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig

# --------------------------------------------------------------------------
# initialisation helpers
# --------------------------------------------------------------------------


def dense_init(shape, generator: torch.Generator, *, in_axis: int = 0,
               lead=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated normal (±2σ) with σ = 1/sqrt(fan_in), as the reference.
    ``lead`` prepends stacking dimensions (the layer axis) that do not count
    towards the fan-in."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.empty(tuple(lead) + tuple(shape), dtype=dtype, device=device)
    return torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                                       generator=generator)


def embed_init(shape, generator: torch.Generator, *, dtype=torch.float32,
               device=None) -> torch.Tensor:
    w = torch.empty(shape, dtype=dtype, device=device)
    return w.normal_(0.0, 0.02, generator=generator)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    y = x32 * inv
    if scale is not None:
        y = y * scale.float()
    return y.to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm; with ``scale=bias=None`` this is OLMo's non-parametric LN."""
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def apply_norm(cfg: ModelConfig, x, params):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, params["scale"])
    if cfg.norm == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    if cfg.norm == "nonparametric_ln":
        return layer_norm(x, None, None)
    raise ValueError(cfg.norm)


def norm_params(cfg: ModelConfig, dtype, device=None, lead=()):
    shape = tuple(lead) + (cfg.d_model,)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    return {}  # non-parametric


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (B, T, H, D); positions: (B, T) int.  Rotates split halves
    ``[x1·cos − x2·sin, x2·cos + x1·sin]``, not interleaved pairs."""
    d_half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, d_half, dtype=torch.float32,
                                   device=x.device) / d_half)
    angles = positions[..., None].float() * freq        # (B,T,d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (dense reference, for the layer-level parity tests)
# --------------------------------------------------------------------------


def attention(q, k, v, mask, *, softmax_scale: Optional[float] = None,
              scores_dtype=torch.float32):
    """GQA attention.  q: (B,T,Hq,D); k,v: (B,S,Hkv,D); mask: (B,T,S) bool."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, T, Hkv, G, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k).to(scores_dtype) * scale
    neg = torch.finfo(scores_dtype).min / 2
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.tensor(neg, dtype=scores_dtype, device=q.device))
    probs = torch.softmax(scores.float(), dim=-1)
    probs = probs.to(scores_dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype), v)
    return out.reshape(B, T, Hq, D)


def causal_mask(q_pos, kv_pos, window: Optional[int] = None):
    """q_pos: (B,T), kv_pos: (B,S) (−1 marks invalid KV slots) -> (B,T,S)."""
    m = kv_pos[:, None, :] <= q_pos[:, :, None]
    m &= kv_pos[:, None, :] >= 0
    if window is not None:
        m &= q_pos[:, :, None] - kv_pos[:, None, :] < window
    return m


# --------------------------------------------------------------------------
# attention block params + apply
# --------------------------------------------------------------------------


def attn_params(cfg: ModelConfig, generator: torch.Generator, dtype, device=None,
                lead=()):
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {
        "wq": dense_init((cfg.d_model, cfg.num_heads, cfg.head_dim), generator, **kw),
        "wk": dense_init((cfg.d_model, cfg.num_kv_heads, cfg.head_dim), generator, **kw),
        "wv": dense_init((cfg.d_model, cfg.num_kv_heads, cfg.head_dim), generator, **kw),
        "wo": dense_init((cfg.num_heads, cfg.head_dim, cfg.d_model), generator,
                         in_axis=1, **kw),
    }
    if cfg.qkv_bias:
        zkw = dict(dtype=dtype, device=device)
        lead = tuple(lead)
        p["bq"] = torch.zeros(lead + (cfg.num_heads, cfg.head_dim), **zkw)
        p["bk"] = torch.zeros(lead + (cfg.num_kv_heads, cfg.head_dim), **zkw)
        p["bv"] = torch.zeros(lead + (cfg.num_kv_heads, cfg.head_dim), **zkw)
    return p


def _proj_heads(x, w):
    """einsum("btd,dhk->bthk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def attn_qkv(cfg: ModelConfig, p, x, positions):
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, ctx):
    """einsum("bthk,hkd->btd") as one matmul over the flattened heads."""
    h, k, d = p["wo"].shape
    return ctx.flatten(-2) @ p["wo"].reshape(h * k, d)


# --------------------------------------------------------------------------
# MLP (dense)
# --------------------------------------------------------------------------


def mlp_params(cfg: ModelConfig, generator: torch.Generator, dtype, device=None,
               d_ff: Optional[int] = None, lead=()):
    d_ff = d_ff or cfg.d_ff
    kw = dict(dtype=dtype, device=device, lead=lead)
    if cfg.mlp_act == "swiglu":
        return {
            "wi": dense_init((cfg.d_model, d_ff), generator, **kw),
            "wg": dense_init((cfg.d_model, d_ff), generator, **kw),
            "wo": dense_init((d_ff, cfg.d_model), generator, **kw),
        }
    return {
        "wi": dense_init((cfg.d_model, d_ff), generator, **kw),
        "wo": dense_init((d_ff, cfg.d_model), generator, **kw),
    }


def mlp(cfg: ModelConfig, p, x):
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]
