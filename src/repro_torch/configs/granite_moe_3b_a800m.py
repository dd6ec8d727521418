"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,             # per-expert FFN width (fine-grained experts)
    vocab=49155,
    n_experts=40,
    top_k=8,
    expert_d_ff=512,
    moe_layer_step=1,     # every layer is MoE
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
