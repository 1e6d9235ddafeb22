"""Llama-3.1-70B — paper evaluation model (§6.1), TP degree 4."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3_70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="llama3_70b_reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, layer_pattern=None,
    )
