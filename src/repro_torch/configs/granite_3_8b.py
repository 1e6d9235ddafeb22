"""Granite-3.0-8B [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base family; hf].

40L, d_model=4096, 32 heads (GQA kv=8), d_ff=12800, vocab=49155.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite_3_8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="granite_3_8b_reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, layer_pattern=None,
    )
