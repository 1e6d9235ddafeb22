"""DBRX-132B [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base;
unverified].

40L, d_model=6144, 48H (GQA kv=8), d_ff=10752 (per expert), vocab=100352,
MoE 16e top-4.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="dbrx_132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    mlp_act="swiglu",
    norm="layernorm",
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="dbrx_132b_reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        layer_pattern=None,
    )
