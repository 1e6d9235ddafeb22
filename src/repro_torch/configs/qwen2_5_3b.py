"""Qwen2.5-3B [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family; hf].

36L, d_model=2048, 16 heads (GQA kv=2), d_ff=11008, vocab=151936.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2_5_3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="qwen2_5_3b_reduced",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        layer_pattern=None,
    )
