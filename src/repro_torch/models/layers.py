"""Model building blocks in PyTorch: the dense, dropless-MoE, Mamba2 (SSD)
and RG-LRU (RecurrentGemma) subsets of ``repro.models.layers``.

Plain functions over explicit parameter dictionaries that keep the JAX
package's names and layouts (attention weights (d, H, Dh) and (H, Dh, d)), so
that :mod:`repro_torch.models.convert` copies parameters without renaming or
transposing.  Compute runs in the input type with fp32 norms, RoPE, softmax
and SSD recurrence, as in the reference.

Conventions: B batch, T query tokens, S KV length, H heads, Hkv KV heads,
D head_dim, d = d_model, F = d_ff; for SSD, H heads of P channels, state N.

:func:`attention`, :func:`causal_mask` and :func:`full_mask` are the
reference's dense, mask-based attention, kept for layer-level parity tests; the model attends
over its cache through :mod:`repro_torch.kernels.ops`.  The deferred KV
append attends over two segments of keys, the cache and the new chunk, each
through a kernel that also returns its log-sum-exp (:func:`attention_partial`:
K1), and merges them exactly (:func:`attention_merge2`).  :func:`ssd_prefill`
runs its chunked scan through ``ops.ssd_scan`` (K3 on the card);
:func:`ssd_decode_step` has no kernel in the reference and stays plain
PyTorch.  :func:`moe` is the reference's dropless MoE; its two grouped
products lie outside any Pallas kernel in the reference
(``jax.lax.ragged_dot``) and stay PyTorch products here
(:func:`grouped_mm`).  :func:`rglru` runs its fp32 recurrence as a chunked
scan in plain PyTorch (:func:`rglru_scan`); the reference has no kernel for
it either (``jax.lax.associative_scan``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

from .config import ModelConfig

# Leaves the reference initialises in fp32 whatever the model's type
# (``repro.models.layers.ssd_params`` and ``moe_params``); conversions leave
# them in fp32.
FP32_LEAVES = frozenset({"A_log", "D", "dt_bias", "router", "log_lambda"})

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


def attention_partial(q, k, v, *, q_offset: Optional[int] = None,
                      window: Optional[int] = None, force: Optional[str] = None):
    """One segment of keys for an online-softmax merge, through K1 (its plain
    version on the CPU): query t at key position ``q_offset + t`` (``S - T``
    by default), causal, with the optional window.  Returns (out (B,T,Hq,D)
    in q's type, normalised over the segment; lse (B,T,Hq) fp32, the
    log-sum-exp of each row's scaled scores, -inf where a row sees no key).

    The reference's ``attention_partial`` returns the unnormalised sum, the
    row max and the row sum (acc, m, l); out = acc / l and lse = m + log l
    carry the same information, and are what a flash kernel produces."""
    return ops.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset,
                               return_lse=True, force=force)


def attention_merge2(seg_a, seg_b, out_dtype):
    """Exact two-segment online-softmax combine of (out, lse) pairs: each
    segment weighs exp(lse - max lse), and out = Σ w·out / Σ w.  A segment
    that saw no key (lse = -inf) weighs 0; a row that neither saw gives 0."""
    out_a, lse_a = seg_a
    out_b, lse_b = seg_b
    m = torch.maximum(lse_a, lse_b)
    m = torch.where(torch.isinf(m), 0.0, m)                  # both empty
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    num = out_a.float() * wa[..., None] + out_b.float() * wb[..., None]
    den = wa + wb
    den = torch.where(den == 0.0, 1.0, den)
    return (num / den[..., None]).to(out_dtype)


def causal_mask(q_pos, kv_pos, window: Optional[int] = None):
    """q_pos: (B,T), kv_pos: (B,S) (−1 marks invalid KV slots) -> (B,T,S)."""
    m = kv_pos[:, None, :] <= q_pos[:, :, None]
    m &= kv_pos[:, None, :] >= 0
    if window is not None:
        m &= q_pos[:, :, None] - kv_pos[:, None, :] < window
    return m


def full_mask(q_pos, kv_pos):
    """Bidirectional (encoder) mask: only invalid slots (kv_pos < 0) masked."""
    B, T = q_pos.shape
    return (kv_pos[:, None, :] >= 0).expand(B, T, kv_pos.shape[1])


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
# Mixture of Experts: sort-based dispatch, grouped products (dropless)
# --------------------------------------------------------------------------


def moe_params(cfg: ModelConfig, generator: torch.Generator, dtype, device=None, lead=()):
    """``router`` (d, E) in fp32 whatever ``dtype``; ``w_in`` (E, d, n_in·F_e)
    and ``w_out`` (E, F_e, d) with their fan-in on axis 1 (after ``lead``)."""
    moe_cfg = cfg.moe
    n_in = 2 if cfg.mlp_act == "swiglu" else 1
    E, F_e = moe_cfg.num_experts, moe_cfg.d_ff_expert
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "router": dense_init((cfg.d_model, E), generator, dtype=torch.float32,
                             device=device, lead=lead),
        "w_in": dense_init((E, cfg.d_model, n_in * F_e), generator, in_axis=1, **kw),
        "w_out": dense_init((E, F_e, cfg.d_model), generator, in_axis=1, **kw),
    }


def moe_route(cfg: ModelConfig, p, xf):
    """Router of :func:`moe`: fp32 logits ``xf @ router``, their softmax, and
    its top-k, renormalised.  xf: (n, d) -> probs (n, E), gate (n, K) and the
    expert ids idx (n, K), both in descending order of probability."""
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, gate / gate.sum(dim=-1, keepdim=True), idx


def grouped_mm(x, w, group_sizes, *, force: Optional[str] = None):
    """``jax.lax.ragged_dot``: rows of ``x`` (m, k) sorted by group, group g's
    ``group_sizes[g]`` rows times ``w[g]`` (G, k, n) -> (m, n) in x's type.

    On the card it is one ``torch._grouped_mm`` call whose group ends are the
    cumulative sizes on the device, so no host read waits on the router; its
    plain version, :func:`grouped_mm_loop`, serves the CPU and
    ``force="plain"``."""
    if ops._use_kernel(x, force):
        return torch._grouped_mm(x, w, offs=torch.cumsum(group_sizes, 0, dtype=torch.int32))
    return grouped_mm_loop(x, w, group_sizes)


def grouped_mm_loop(x, w, group_sizes):
    """The plain version of :func:`grouped_mm`: one product per expert over
    its rows, the sizes read on the host."""
    out = x.new_empty((x.shape[0], w.shape[-1]))
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        out[start:start + size] = x[start:start + size] @ w[g]
        start += size
    return out


def moe(cfg: ModelConfig, p, x, *, force: Optional[str] = None):
    """Dropless MoE, as the reference: route, sort the (token, choice) pairs
    by expert (stable), two grouped products, scatter-add back weighted by
    the gates.  x: (B, T, d) -> (y (B, T, d), {"moe_aux_loss",
    "expert_load"}), the Switch-style load-balance loss and each expert's
    share of the n·K choices.  ``force="plain"`` runs the per-expert loop."""
    moe_cfg = cfg.moe
    E, K = moe_cfg.num_experts, moe_cfg.top_k
    B, T, d = x.shape
    n = B * T
    xf = x.reshape(n, d)
    probs, gate, idx = moe_route(cfg, p, xf)
    flat_expert = idx.reshape(-1)                                     # (n*K,)
    sort_idx = torch.argsort(flat_expert, stable=True)
    token_of = sort_idx // K
    xs = xf[token_of]                                                 # (n*K, d)
    # a scatter, not bincount, which reads the largest id on the host
    group_sizes = torch.zeros(E, dtype=torch.int32, device=x.device).index_add_(
        0, flat_expert, torch.ones_like(flat_expert, dtype=torch.int32))

    h = grouped_mm(xs, p["w_in"], group_sizes, force=force)          # (n*K, n_in*F_e)
    if cfg.mlp_act == "swiglu":
        hi, hg = torch.chunk(h, 2, dim=-1)
        h = F.silu(hi) * hg
    else:
        h = F.gelu(h, approximate="tanh")
    ys = grouped_mm(h, p["w_out"], group_sizes, force=force)         # (n*K, d)

    flat_gate = gate.reshape(-1)[sort_idx]
    ys = ys * flat_gate[:, None].to(ys.dtype)
    out = torch.zeros((n, d), dtype=ys.dtype, device=x.device).index_add_(0, token_of, ys)

    me = probs.mean(dim=0)                                            # (E,)
    ce = group_sizes.float() / (n * K)
    aux_loss = E * torch.sum(me * ce)
    return out.reshape(B, T, d), {"moe_aux_loss": aux_loss, "expert_load": ce}


# --------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin)
# --------------------------------------------------------------------------

RGLRU_CHUNK = 16    # positions of one block of the chunked scan (rglru_scan)


def rglru_params(cfg: ModelConfig, generator: torch.Generator, dtype, device=None, lead=()):
    """The reference's RG-LRU block: input and gate branches, the recurrence
    and input gates, the output projection, the depthwise conv and the fp32
    Λ, a linspace from −4.3 to −9.0 over the width."""
    rg = cfg.rglru
    w = rg.lru_width
    kw = dict(dtype=dtype, device=device, lead=lead)
    lam = torch.linspace(-4.3, -9.0, w, dtype=torch.float32, device=device)
    return {
        "w_x": dense_init((cfg.d_model, w), generator, **kw),
        "w_gate_in": dense_init((cfg.d_model, w), generator, **kw),
        "w_a": dense_init((w, w), generator, **kw),
        "w_i": dense_init((w, w), generator, **kw),
        "w_out": dense_init((w, cfg.d_model), generator, **kw),
        "conv": dense_init((rg.conv_width, w), generator, **kw),
        "log_lambda": lam.expand(tuple(lead) + (w,)).clone(),
    }


def rglru_scan(log_a, b, h0, chunk: int = RGLRU_CHUNK):
    """h_t = exp(log_a_t)·h_{t−1} + b_t from h_{−1} = h0, every t at once.
    log_a, b: (B, T, W) fp32; h0: (B, W) fp32 -> h (B, T, W) fp32.

    In blocks of ``chunk`` positions: inside a block h is a sum of b_s
    weighted by exp(cum_t − cum_s), the block-local cumulative sums of
    log_a, which stay small (a single cumulative sum over T overflows
    exp(−·) in fp32 past about 800 positions at Λ = −4.3); across blocks
    each block's entering state is the same sum over the blocks before it,
    their decays summed in fp64.  Every exponent is a difference of later
    minus earlier sums, so it is at most 0 and nothing is divided.  A ragged
    last block is padded with a = 1, b = 0, which leaves the earlier
    positions as they are.  T = 1 is the one step."""
    B, T, W = b.shape
    if T == 1:
        return torch.exp(log_a) * h0[:, None, :] + b
    pad = (-T) % chunk
    if pad:
        log_a = F.pad(log_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    n = (T + pad) // chunk
    la = log_a.view(B, n, chunk, W)
    cum = torch.cumsum(la, dim=2)                                     # (B, n, C, W)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=b.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]              # (B, n, t, s, W)
    weights = torch.exp(diff.masked_fill(~causal[:, :, None], -math.inf))
    local = (weights * b.view(B, n, 1, chunk, W)).sum(dim=3)          # from a zero state
    # the state entering block c: the blocks before it, decayed to its start
    ends = torch.cumsum(cum[:, :, -1, :].double(), dim=1)             # (B, n, W) fp64
    blocks = torch.tril(torch.ones(n, n, dtype=torch.bool, device=b.device))
    decay = torch.exp((ends[:, :, None, :] - ends[:, None, :, :]).masked_fill(
        ~blocks[:, :, None], -math.inf)).float()                      # (B, c, c', W)
    after = (decay * local[:, None, :, -1, :]).sum(dim=2) \
        + torch.exp(ends).float() * h0[:, None, :]                    # state after block c
    entering = torch.cat([h0[:, None, :], after[:, :-1]], dim=1)
    h = local + torch.exp(cum) * entering[:, :, None, :]
    return h.reshape(B, n * chunk, W)[:, :T]


def rglru(cfg: ModelConfig, p, x, h0=None, conv_state=None):
    """RG-LRU block.  x: (B,T,d) -> (y (B,T,d), hT (B,W) fp32, conv_stateT).

    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ u_t) with
    a_t = exp(−8 · softplus(Λ) · r_t), the r and i gates from the conv'd
    input branch; the recurrence runs in fp32 (:func:`rglru_scan`)."""
    B, T, _ = x.shape
    u = x @ p["w_x"]                                       # (B,T,W)
    g = F.silu(x @ p["w_gate_in"])                         # gate branch
    u_conv, conv_state = _causal_conv1d(u, p["conv"], conv_state)
    r = torch.sigmoid(u_conv @ p["w_a"]).float()
    i = torch.sigmoid(u_conv @ p["w_i"]).float()
    log_a = -8.0 * F.softplus(p["log_lambda"]) * r         # (B,T,W) fp32
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * i * u_conv.float()
    if h0 is None:
        h0 = torch.zeros((B, u.shape[-1]), dtype=torch.float32, device=x.device)
    h = rglru_scan(log_a, b, h0)
    y = (h.to(x.dtype) * g) @ p["w_out"]
    return y, h[:, -1, :], conv_state


def rglru_step(cfg: ModelConfig, p, x_t, h_prev, conv_state):
    """Single decode step.  x_t: (B,1,d); h_prev: (B,W); conv: (B,K-1,W)."""
    return rglru(cfg, p, x_t, h0=h_prev, conv_state=conv_state)


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
