"""Config registry of the port (``src/repro/configs/__init__.py``).

Every selectable ``--arch`` id maps to a ModelConfig, as in the
reference: its ten ``ASSIGNED`` architectures and the paper's GPT
models, and, apart, the ResNets (``RESNET_REGISTRY``).
"""
from __future__ import annotations

from repro_torch.configs import resnet50 as _resnet50
from repro_torch.configs.base import ModelConfig, vocab_pad
from repro_torch.configs.command_r_35b import CONFIG as _command_r_35b
from repro_torch.configs.gpt_models import GPT_117M, GPT_800M, GPT_13B, GPT_175B
from repro_torch.configs.granite_8b import CONFIG as _granite_8b
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite_moe
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.llama3_2_3b import CONFIG as _llama3_2_3b
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _llama4
from repro_torch.configs.llava_next_34b import CONFIG as _llava_next_34b
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2_0_5b
from repro_torch.configs.whisper_small import CONFIG as _whisper_small

#: the reference's 10 assigned architectures
ASSIGNED: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _granite_8b,
        _qwen2_0_5b,
        _command_r_35b,
        _llama3_2_3b,
        _whisper_small,
        _llava_next_34b,
        _jamba,
        _mamba2,
        _granite_moe,
        _llama4,
    )
}

#: the paper's own models
PAPER_MODELS: dict[str, ModelConfig] = {
    c.name: c for c in (GPT_117M, GPT_800M, GPT_13B, GPT_175B)
}

REGISTRY: dict[str, ModelConfig] = {**ASSIGNED, **PAPER_MODELS}

RESNET_REGISTRY = {
    "resnet50": _resnet50.CONFIG,
    "resnet18": _resnet50.RESNET18,
    "resnet34": _resnet50.RESNET34,
}


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(REGISTRY)}"
        ) from None


__all__ = ["ASSIGNED", "ModelConfig", "PAPER_MODELS", "REGISTRY",
           "RESNET_REGISTRY", "get_config", "vocab_pad"]
