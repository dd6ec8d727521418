"""whisper-small — enc-dec audio backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,          # decoder layers
    n_enc_layers=12,
    enc_seq=1500,         # 30 s of audio at 50 frames/s (post-conv)
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    mlp_bias=True,
    use_rope=False,       # learned absolute positions
    max_position=40960,   # covers decode_32k; long_500k is skipped (quad.)
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)
