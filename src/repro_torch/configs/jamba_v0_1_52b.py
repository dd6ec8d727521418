"""jamba-v0.1-52b — hybrid Mamba+attention (1:7 interleave) with MoE
(16 experts, top-2, every 2nd layer) [arXiv:2403.19887; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    # hybrid pattern: one attention layer per 8 (1:7 mamba:attn interleave)
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    # MoE on every 2nd layer
    n_experts=16,
    top_k=2,
    expert_d_ff=14336,
    moe_layer_step=2,
    use_rope=False,       # Jamba uses no positional encoding in attn layers
    long_context_ok=True,  # only 4 attention layers; KV seq-sharded
    source="arXiv:2403.19887; hf",
)
