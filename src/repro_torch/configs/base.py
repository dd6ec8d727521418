"""Model configuration for the PyTorch port.

Port of ``src/repro/configs/base.py``: the frozen :class:`ModelConfig`
with ``.reduced()`` and ``padded_vocab``, and the input shapes of the
dry-run cells (:class:`ShapeConfig`, ``SHAPES``). Framework-neutral, kept as the
port's own copy so that ``repro_torch`` imports nothing of ``repro``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell's input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def vocab_pad(vocab: int, multiple: int = 256) -> int:
    """Megatron-style vocab padding (make_vocab_size_divisible_by)."""
    return int(math.ceil(vocab / multiple) * multiple)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description; the fields mirror the reference's.

    family: dense | moe | ssm | hybrid | encdec | vlm.
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

    @property
    def group_size(self) -> int:
        """GQA group size (query heads per KV head)."""
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def is_moe_layer(self, i: int) -> bool:
        """MoE on the layers ``i % step == step - 1`` (step 2: 1, 3, 5...)."""
        if self.n_experts == 0:
            return False
        return (i % self.moe_layer_step) == (self.moe_layer_step - 1)

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid: layer ``attn_layer_offset`` of each period is attention
        (the others Mamba); ssm: none; every other family: all."""
        if self.family != "hybrid":
            return self.family != "ssm"
        return (i % self.attn_layer_period) == self.attn_layer_offset

    def param_count(self) -> int:
        """Analytic parameter count (the reference's; excludes a learned
        position table)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters one token uses: ``top_k`` of the experts."""
        return _param_count(self, active_only=True)

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


def _attn_params(c: ModelConfig) -> int:
    qo = 2 * c.d_model * c.n_heads * c.d_head
    kv = 2 * c.d_model * c.n_kv_heads * c.d_head
    bias = (c.n_heads + 2 * c.n_kv_heads) * c.d_head if c.qkv_bias else 0
    return qo + kv + bias


def _mlp_params(c: ModelConfig, d_ff: int) -> int:
    n_mats = 3 if c.act == "swiglu" else 2
    return n_mats * c.d_model * d_ff + (c.mlp_bias and (n_mats - 1) * d_ff
                                        + c.d_model or 0)


def _mamba_params(c: ModelConfig) -> int:
    di, ns, nh = c.d_inner, c.ssm_state, c.ssm_nheads
    in_proj = c.d_model * (2 * di + 2 * ns + nh)  # z, x, B, C, dt
    conv = (di + 2 * ns) * c.ssm_conv
    out = di * c.d_model
    extras = 2 * nh + di  # A_log, D, norm
    return in_proj + conv + out + extras


def _param_count(c: ModelConfig, active_only: bool) -> int:
    """Same arithmetic as the reference's ``configs.base._param_count``."""
    total = c.padded_vocab * c.d_model  # embedding
    if not c.tie_embeddings:
        total += c.padded_vocab * c.d_model  # lm head
    per_norm = c.d_model * (2 if c.norm == "layernorm" else 1)

    def layer_params(i: int, cross: bool = False) -> int:
        p = 0
        if c.is_attn_layer(i):
            p += _attn_params(c) + per_norm
            if cross:
                p += _attn_params(c) + per_norm
        else:
            p += _mamba_params(c) + per_norm
        if c.family == "ssm":
            return p
        if c.is_moe_layer(i):
            eff = c.expert_d_ff or c.d_ff
            n_used = c.top_k if active_only else c.n_experts
            p += n_used * _mlp_params(c, eff) + per_norm
            if c.moe_shared:
                p += _mlp_params(c, eff)
            p += c.d_model * c.n_experts  # router
        elif c.d_ff:
            p += _mlp_params(c, c.d_ff) + per_norm
        return p

    for i in range(c.n_layers):
        total += layer_params(i, cross=c.family == "encdec")
    for i in range(c.n_enc_layers):
        total += _attn_params(c) + _mlp_params(c, c.d_ff) + 2 * per_norm
    total += per_norm  # final norm
    return total
