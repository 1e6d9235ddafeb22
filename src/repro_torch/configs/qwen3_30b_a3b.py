"""Qwen3-30B-A3B — paper evaluation model (§6.1), sparse MoE, EP degree 2."""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3_30b_a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="qwen3_30b_a3b_reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
        layer_pattern=None,
    )
