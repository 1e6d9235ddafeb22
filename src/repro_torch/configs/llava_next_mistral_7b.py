"""LLaVA-NeXT-Mistral-7B [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone only per assignment: 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=32000.  The vision frontend (CLIP tower + anyres tiling) is a STUB:
``input_specs()`` provides precomputed patch embeddings of shape
(batch, frontend_tokens, d_model); 2880 patch tokens models a 2x2 anyres grid
plus base tile (5 tiles x 576 patches).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava_next_mistral_7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    frontend_tokens=2880,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="llava_next_mistral_7b_reduced",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, frontend_tokens=16, layer_pattern=None,
    )
