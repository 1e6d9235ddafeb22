"""RecurrentGemma-2B [hybrid] — RG-LRU + local attention, 1:2 ratio
[arXiv:2402.19427; hf].

26L, d_model=2560, 10H (MQA kv=1), d_ff=7680, vocab=256000.  Layer pattern:
(rglru, rglru, local_attn) repeating; local attention window 2048.
Sub-quadratic decode => long_500k cell runs.
"""

from repro_torch.models.config import ModelConfig, RGLRUConfig

_PATTERN = (["rglru", "rglru", "local_attn"] * 9)[:26]

CONFIG = ModelConfig(
    arch_id="recurrentgemma_2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    mlp_act="swiglu",
    norm="rmsnorm",
    sliding_window=2048,
    layer_pattern=_PATTERN,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="recurrentgemma_2b_reduced",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, sliding_window=64,
        layer_pattern=["rglru", "rglru", "local_attn"],
        rglru=RGLRUConfig(lru_width=64, conv_width=4),
    )
