"""mamba2-1.3b — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    long_context_ok=True,  # constant-state decode
    source="arXiv:2405.21060; unverified",
)
