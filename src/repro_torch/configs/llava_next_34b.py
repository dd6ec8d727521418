"""llava-next-34b — VLM backbone; anyres tiling frontend is a STUB
(input_specs provides precomputed patch embeddings prepended to the text
sequence) [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    n_patches=2880,       # anyres: 5 tiles x 576 patches
    rope_theta=5_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
