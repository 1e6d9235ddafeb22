"""OLMo-1B [dense] — non-parametric LayerNorm [arXiv:2402.00838; hf].

16L, d_model=2048, 16 heads (kv=16, i.e. MHA), d_ff=8192, vocab=50304.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmo_1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    mlp_act="swiglu",
    norm="nonparametric_ln",
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="olmo_1b_reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, layer_pattern=None,
    )
