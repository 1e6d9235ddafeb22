"""Mamba2-370M [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].

48L, d_model=1024, d_ff=0 (no MLP stack; SSD blocks only), vocab=50280,
ssm_state=128.  O(1)-state decode => long_500k cell runs.
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2_370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1,          # unused by SSD blocks (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    norm="rmsnorm",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=128),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        arch_id="mamba2_370m_reduced",
        num_layers=2, d_model=64, vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=16),
        layer_pattern=None,
    )
