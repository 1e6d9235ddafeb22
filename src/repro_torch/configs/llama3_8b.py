"""Llama-3.1-8B — paper evaluation model (§6.1), TP degree 1."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3_8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="llama3_8b_reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, layer_pattern=None,
    )
