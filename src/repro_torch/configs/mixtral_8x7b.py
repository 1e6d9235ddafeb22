"""Mixtral-8x7B [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf].

32L, d_model=4096, 32H (GQA kv=8), d_ff=14336 (per expert), vocab=32000,
MoE 8e top-2, SWA window 4096.  SWA bounds per-step KV reads, so the
long_500k decode cell RUNS for this arch (see DESIGN.md).
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="mixtral_8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="mixtral_8x7b_reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, sliding_window=64,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        layer_pattern=None,
    )
