"""Model building blocks in PyTorch: the dense and Mamba2 (SSD) subsets of
``repro.models.layers``.

Plain functions over explicit parameter dictionaries that keep the JAX
package's names and layouts (attention weights (d, H, Dh) and (H, Dh, d)), so
that :mod:`repro_torch.models.convert` copies parameters without renaming or
transposing.  Compute runs in the input type with fp32 norms, RoPE, softmax
and SSD recurrence, as in the reference.

Conventions: B batch, T query tokens, S KV length, H heads, Hkv KV heads,
D head_dim, d = d_model, F = d_ff; for SSD, H heads of P channels, state N.

:func:`attention` and :func:`causal_mask` are the reference's dense,
mask-based attention, kept for layer-level parity tests; the model attends
over its cache through :mod:`repro_torch.kernels.ops`.  :func:`ssd_prefill`
runs its chunked scan through ``ops.ssd_scan`` (K3 on the card);
:func:`ssd_decode_step` has no kernel in the reference and stays plain
PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

from .config import ModelConfig

# Leaves the reference initialises in fp32 whatever the model's type
# (``repro.models.layers.ssd_params``); conversions leave them in fp32.
FP32_LEAVES = frozenset({"A_log", "D", "dt_bias"})

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


# --------------------------------------------------------------------------
# Mamba2 / SSD (state-space duality)
# --------------------------------------------------------------------------


def _causal_conv1d(x, weights, state=None):
    """Depthwise causal conv.  x: (B,T,W); weights: (K,W); state: (B,K-1,W)."""
    K = weights.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, T+K-1, W)
    T = x.shape[1]
    out = sum(xp[:, i:i + T, :] * weights[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return out, new_state


def ssd_params(cfg: ModelConfig, generator: torch.Generator, dtype, device=None, lead=()):
    ssm = cfg.ssm
    d_in = ssm.d_inner(cfg.d_model)
    nheads = ssm.num_heads(cfg.d_model)
    kw = dict(dtype=dtype, device=device, lead=lead)
    heads = tuple(lead) + (nheads,)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj emits [z (gate), x, B, C, dt]
        "w_in": dense_init((cfg.d_model, 2 * d_in + 2 * ssm.state_dim + nheads), generator,
                           **kw),
        "conv": dense_init((ssm.conv_width, d_in + 2 * ssm.state_dim), generator, **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)).expand(heads).clone(),
        "D": torch.ones(heads, **f32),
        "dt_bias": torch.zeros(heads, **f32),
        "w_out": dense_init((d_in, cfg.d_model), generator, **kw),
        "norm_scale": torch.ones(tuple(lead) + (d_in,), dtype=dtype, device=device),
    }


def _ssd_split(cfg: ModelConfig, p, x):
    ssm = cfg.ssm
    d_in = ssm.d_inner(cfg.d_model)
    nheads = ssm.num_heads(cfg.d_model)
    zxbcdt = x @ p["w_in"]
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * ssm.state_dim, nheads], dim=-1)
    return z, xbc, dt, d_in, nheads


def ssd_prefill(cfg: ModelConfig, p, x, state=None, conv_state=None, *,
                force: Optional[str] = None):
    """Mamba2 block over a sequence (chunked SSD).  x: (B,T,d), any T >= 1.

    Returns (y, final_state (B,H,N,P) fp32, conv_state (B,K-1,d_conv)).  The
    scan goes through ``ops.ssd_scan`` with ``state`` as its initial state;
    B and C are handed over as fp32 views of the projection (no copy in fp32).
    """
    ssm = cfg.ssm
    B, T, _ = x.shape
    z, xbc, dt, d_in, H = _ssd_split(cfg, p, x)
    xbc, conv_state = _causal_conv1d(xbc, p["conv"], conv_state)
    xbc = F.silu(xbc)
    xs, Bmat, Cmat = torch.split(xbc, [d_in, ssm.state_dim, ssm.state_dim], dim=-1)
    P = ssm.head_dim
    xh = xs.reshape(B, T, H, P)
    dt = F.softplus(dt.float() + p["dt_bias"])                        # (B,T,H)
    A = -torch.exp(p["A_log"])                                        # (H,)
    y, state = ops.ssd_scan(xh.float() * dt[..., None], dt * A, Bmat.float(), Cmat.float(),
                            chunk=ssm.chunk_size, initial_state=state, force=force)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B, T, d_in).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm_scale"])
    return y @ p["w_out"], state, conv_state


def ssd_chunked_ref(xh, dt, A, Bmat, Cmat, *, chunk: int, initial_state=None):
    """Chunked SSD reference.  xh:(B,T,H,P) dt:(B,T,H) A:(H,) B/C:(B,T,N).

    h_t = a_t h_{t-1} + dt_t B_t x_t, y_t = C_t·h_t, with a_t = exp(dt_t A).
    Unlike the reference it takes any T: a ragged last chunk is padded with
    zeros, which is exact (see ``kernels.ref.ssd_scan_chunked``)."""
    return ref.ssd_scan_chunked(xh.float() * dt[..., None], dt * A, Bmat, Cmat, chunk=chunk,
                                initial_state=initial_state)


def ssd_decode_step(cfg: ModelConfig, p, x_t, state, conv_state):
    """Single-token SSD update.  x_t: (B,1,d); state: (B,H,N,P)."""
    ssm = cfg.ssm
    B = x_t.shape[0]
    z, xbc, dt, d_in, H = _ssd_split(cfg, p, x_t)
    xbc, conv_state = _causal_conv1d(xbc, p["conv"], conv_state)
    xbc = F.silu(xbc)
    xs, Bmat, Cmat = torch.split(xbc, [d_in, ssm.state_dim, ssm.state_dim], dim=-1)
    P = ssm.head_dim
    xh = xs.reshape(B, H, P).float()
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])                  # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt1 * A[None, :])                                    # (B,H)
    Bv = Bmat[:, 0].float()                                            # (B,N)
    Cv = Cmat[:, 0].float()
    dx = xh * dt1[..., None]                                           # (B,H,P)
    state = state * a[:, :, None, None] + torch.einsum("bn,bhp->bhnp", Bv, dx)
    y = torch.einsum("bn,bhnp->bhp", Cv, state)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, d_in).to(x_t.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm_scale"])
    return y @ p["w_out"], state, conv_state
