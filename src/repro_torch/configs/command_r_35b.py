"""command-r-35b — dense GQA, no-bias, 256k vocab
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    norm="layernorm",
    act="swiglu",
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
