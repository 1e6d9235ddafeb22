"""Granite-8B-Code [dense] — llama-architecture code model [arXiv:2405.04324; hf].

36L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=49152.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite_8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="granite_8b_reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, layer_pattern=None,
    )
