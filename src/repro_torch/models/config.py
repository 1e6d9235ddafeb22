"""Model configuration schema shared by the model zoo, the runtime predictor,
the serving engine, and the dry-run launcher.

One :class:`ModelConfig` instance fully determines:

* the parameter tree (`repro.models.transformer/encdec/ssm` build from it),
* the analytical cost model (`repro.core.predictor`),
* KV-cache / recurrent-state geometry (`repro.serving.kv_cache`),
* the sharding rules (`repro.launch.mesh`).

Layer pattern mini-language: ``layer_pattern`` is a list of block kinds, one
entry per layer, drawn from ``{"attn", "local_attn", "rglru", "ssd"}``.  Dense
transformers use ``["attn"] * L``; RecurrentGemma uses the 1:2 pattern
``["rglru", "rglru", "local_attn"] * (L//3)``; Mamba2 uses ``["ssd"] * L``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

__all__ = ["MoEConfig", "SSMConfig", "EncoderConfig", "ModelConfig"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    @property
    def active_ratio(self) -> float:
        return self.top_k / self.num_experts


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block geometry [arXiv:2405.21060]."""

    state_dim: int = 128          # N: SSM state size
    head_dim: int = 64            # P: channels per SSD head
    expand: int = 2               # d_inner = expand * d_model
    chunk_size: int = 128         # SSD chunk length (TPU: multiple of 128)
    conv_width: int = 4           # short causal conv

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec models (whisper).  The conv/audio frontend is
    a stub per the assignment: ``input_specs()`` feeds precomputed frame
    embeddings of shape (batch, n_frames, d_model)."""

    num_layers: int
    num_heads: int
    max_source_positions: int = 1500  # whisper: 30 s of audio @ 50 Hz


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block geometry [arXiv:2402.19427]."""

    lru_width: int = 2560
    conv_width: int = 4
    block_width_multiplier: float = 1.0


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // num_heads
    qkv_bias: bool = False
    mlp_act: str = "swiglu"         # swiglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparametric_ln
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None      # SWA (mixtral) / local attn span
    layer_pattern: Optional[Sequence[str]] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None   # present => enc-dec
    tie_embeddings: bool = False
    max_seq_len: int = 131_072
    dtype: str = "bfloat16"
    # Modality frontends (stubs per assignment): inputs arrive as embeddings.
    frontend: Optional[str] = None  # None | "audio_frames" | "vision_patches"
    frontend_tokens: int = 0        # frames/patches prepended per sample
    # §Perf lowering knobs (EXPERIMENTS.md): dtype of materialized attention
    # scores in the dense lowering, the MoE execution strategy, and the
    # KV-append strategy (defer = one post-stack scatter for all layers via
    # two-segment online-softmax attention, instead of a full per-layer
    # cache rewrite inside the scan carry).
    attn_scores_dtype: str = "float32"   # float32 | bfloat16
    moe_impl: str = "ragged"             # ragged | a2a (shard_map EP)
    kv_append: str = "inline"            # inline | defer

    # ------------------------------------------------------------ derived --
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.layer_pattern is None:
            kind = "ssd" if self.family == "ssm" else "attn"
            object.__setattr__(self, "layer_pattern", tuple([kind] * self.num_layers))
        else:
            pat = tuple(self.layer_pattern)
            assert len(pat) == self.num_layers, (
                f"layer_pattern length {len(pat)} != num_layers {self.num_layers}"
            )
            object.__setattr__(self, "layer_pattern", pat)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder is not None

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def dtype_bytes(self) -> int:
        return {"bfloat16": 2, "float32": 4, "float16": 2, "float8": 1}[self.dtype]

    # --------------------------------------------------------- accounting --
    def attn_params_per_layer(self) -> int:
        qkv = self.d_model * (self.q_size + 2 * self.kv_size)
        if self.qkv_bias:
            qkv += self.q_size + 2 * self.kv_size
        out = self.q_size * self.d_model
        return qkv + out

    def mlp_params_per_layer(self) -> int:
        n_mats = 3 if self.mlp_act == "swiglu" else 2
        if self.moe is not None:
            router = self.d_model * self.moe.num_experts
            return router + self.moe.num_experts * n_mats * self.d_model * self.moe.d_ff_expert
        return n_mats * self.d_model * self.d_ff

    def active_mlp_params_per_layer(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        n_mats = 3 if self.mlp_act == "swiglu" else 2
        if self.moe is not None:
            router = self.d_model * self.moe.num_experts
            return router + self.moe.top_k * n_mats * self.d_model * self.moe.d_ff_expert
        return n_mats * self.d_model * self.d_ff

    def ssd_params_per_layer(self) -> int:
        assert self.ssm is not None
        d_in = self.ssm.d_inner(self.d_model)
        nheads = self.ssm.num_heads(self.d_model)
        # in_proj produces [z, x, B, C, dt]; out_proj back to d_model.
        zx = 2 * d_in
        bc = 2 * self.ssm.state_dim
        proj_in = self.d_model * (zx + bc + nheads)
        conv = self.ssm.conv_width * (d_in + 2 * self.ssm.state_dim)
        skip = nheads * 3  # A_log, D, dt_bias
        gate_norm = d_in   # pre-out-proj RMSNorm scale
        proj_out = d_in * self.d_model
        return proj_in + conv + skip + gate_norm + proj_out

    def rglru_params_per_layer(self) -> int:
        assert self.rglru is not None
        w = self.rglru.lru_width
        # x/gate in-proj + out-proj + recurrence/input gates + conv + Λ.
        return (
            2 * self.d_model * w      # in-proj (x branch, gate branch)
            + w * self.d_model        # out-proj
            + 2 * w * w               # RG-LRU recurrence + input gates
            + self.rglru.conv_width * w
            + w                       # Λ (log-recurrence weights)
        )

    def block_params(self, kind: str) -> int:
        if kind in ("attn", "local_attn"):
            return self.attn_params_per_layer() + self.mlp_params_per_layer()
        if kind == "ssd":
            return self.ssd_params_per_layer()
        if kind == "rglru":
            return self.rglru_params_per_layer() + self.mlp_params_per_layer()
        raise ValueError(f"unknown block kind {kind!r}")

    def norm_unit(self) -> int:
        """Parameters per norm instance."""
        return {"rmsnorm": self.d_model, "layernorm": 2 * self.d_model,
                "nonparametric_ln": 0}[self.norm]

    def param_count(self) -> int:
        """Total parameters (embeddings + blocks + norms [+ encoder]).

        Exact by construction — tests/test_models_smoke.py asserts equality
        against the real parameter tree for every architecture; the
        analytical predictor and the roofline both trust this number."""
        n = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model  # unembed
        n += sum(self.block_params(k) for k in self.layer_pattern)
        u = self.norm_unit()
        # SSD blocks carry a single pre-norm; every other kind has two.
        norms = sum(1 if k == "ssd" else 2 for k in self.layer_pattern) + 1
        n += u * norms
        if self.encoder is not None:
            # learned absolute positions for the decoder
            n += self.max_seq_len * self.d_model
            enc_layer = (self.attn_params_per_layer()
                         + self.mlp_params_per_layer() + 2 * u)
            n += self.encoder.num_layers * enc_layer + u  # + enc_final_norm
            # decoder cross-attention: one (norm + attn) block per layer
            n += self.num_layers * (self.attn_params_per_layer() + u)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (= param_count for dense)."""
        n = self.param_count()
        if self.moe is not None:
            n -= sum(
                self.mlp_params_per_layer() - self.active_mlp_params_per_layer()
                for k in self.layer_pattern
                if k in ("attn", "local_attn")
            )
        return n

    def kv_bytes_per_token_per_layer(self) -> int:
        return 2 * self.kv_size * self.dtype_bytes

    def num_attn_layers(self) -> int:
        return sum(1 for k in self.layer_pattern if k in ("attn", "local_attn"))

    def kv_bytes_per_token(self) -> int:
        return self.num_attn_layers() * self.kv_bytes_per_token_per_layer()

    def recurrent_state_bytes(self) -> int:
        """Per-sequence fixed-size state (SSD / RG-LRU), bytes, fp32 state."""
        total = 0
        for k in self.layer_pattern:
            if k == "ssd":
                assert self.ssm is not None
                nheads = self.ssm.num_heads(self.d_model)
                total += nheads * self.ssm.head_dim * self.ssm.state_dim * 4
                total += self.ssm.conv_width * self.ssm.d_inner(self.d_model) * 4
            elif k == "rglru":
                assert self.rglru is not None
                total += self.rglru.lru_width * 4
        return total

    def supports_long_context(self) -> bool:
        """True iff decode cost is sub-quadratic in context (long_500k cell)."""
        kinds = set(self.layer_pattern)
        if kinds <= {"ssd", "rglru", "local_attn"}:
            return True
        if kinds == {"attn"} and self.sliding_window is not None:
            return True  # SWA bounds per-step KV reads
        return False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
