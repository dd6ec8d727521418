"""Model configuration for the PyTorch port.

Port of ``src/repro/configs/base.py``: the frozen :class:`ModelConfig`
with ``.reduced()`` and ``padded_vocab``. Framework-neutral, kept as the
port's own copy so that ``repro_torch`` imports nothing of ``repro``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional


def vocab_pad(vocab: int, multiple: int = 256) -> int:
    """Megatron-style vocab padding (make_vocab_size_divisible_by)."""
    return int(math.ceil(vocab / multiple) * multiple)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description; the fields mirror the reference's.

    family: dense | moe | ssm | hybrid | encdec | vlm. The port runs
    ``dense`` only so far; the other families raise where they are used.
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    d_head: int = 0                 # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    mlp_bias: bool = False
    attn_window: Optional[int] = None
    use_rope: bool = True
    max_position: int = 1 << 20
    logits_softcap: float = 0.0

    # norms / activations
    norm: str = "rmsnorm"           # "rmsnorm" | "layernorm"
    act: str = "swiglu"             # "swiglu" | "gelu"
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    moe_layer_step: int = 1
    moe_shared: bool = False
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    attn_layer_period: int = 0
    attn_layer_offset: int = 0

    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq: int = 0

    # VLM
    n_patches: int = 0

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # bookkeeping
    source: str = ""
    long_context_ok: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head",
                               self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return vocab_pad(self.vocab)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests (same rule as the
        reference, so both packages build identical shapes)."""
        small: dict = dict(
            n_layers=max(2, self.moe_layer_step
                         * max(1, self.attn_layer_period or 1)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            d_ff=128,
            vocab=512,
            d_head=16,
        )
        if self.n_experts:
            small.update(n_experts=min(self.n_experts, 4), expert_d_ff=64,
                         top_k=min(self.top_k, 2))
        if self.ssm_state:
            small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
        if self.attn_layer_period:
            small.update(attn_layer_period=min(self.attn_layer_period, 4),
                         attn_layer_offset=min(self.attn_layer_offset, 3),
                         n_layers=2 * min(self.attn_layer_period, 4))
        if self.n_enc_layers:
            small.update(n_enc_layers=2, enc_seq=32)
        if self.n_patches:
            small.update(n_patches=16)
        if self.family == "ssm":
            small.update(n_heads=0, n_kv_heads=0, d_ff=0, d_head=0)
        small["name"] = self.name + "-reduced"
        small.update(overrides)
        return replace(self, **small)
