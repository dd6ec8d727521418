"""llama4-maverick-400b-a17b — MoE 128 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Interpretation (DESIGN.md par.4): MoE on every 2nd layer (the published
Maverick `interleave_moe_layer_step=2`), dense SwiGLU on the others — this
matches the "400b total / a17b active" naming; MoE-on-every-layer would be
~780 B params. long_500k is runnable via the published chunked/local
attention (iRoPE) window of 8192.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=16384,           # dense (non-MoE) layers; experts use 8192 below
    vocab=202048,
    n_experts=128,
    top_k=1,
    expert_d_ff=8192,
    moe_layer_step=2,
    moe_shared=True,      # shared expert in parallel with the routed one
    attn_window=8192,     # chunked attention (iRoPE) -> sub-quadratic
    rope_theta=500_000.0,
    long_context_ok=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
