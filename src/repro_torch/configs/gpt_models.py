"""The paper's GPT models (``src/repro/configs/gpt_models.py``)."""
from repro_torch.configs.base import ModelConfig

_COMMON = dict(
    family="dense",
    vocab=50257,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    mlp_bias=True,
    use_rope=True,
    tie_embeddings=True,
)

GPT_117M = ModelConfig(
    name="gpt-117m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, source="CARAML paper (Graphcore case, Table II)", **_COMMON)

GPT_800M = ModelConfig(
    name="gpt-800m", n_layers=24, d_model=1536, n_heads=16, n_kv_heads=16,
    d_ff=6144, source="CARAML paper (NVIDIA/AMD case, Fig. 2)", **_COMMON)

GPT_13B = ModelConfig(
    name="gpt-13b", n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=20480, source="CARAML paper (13B JUBE config)", **_COMMON)

GPT_175B = ModelConfig(
    name="gpt-175b", n_layers=96, d_model=12288, n_heads=96, n_kv_heads=96,
    d_ff=49152, source="CARAML paper (175B JUBE config)", **_COMMON)
