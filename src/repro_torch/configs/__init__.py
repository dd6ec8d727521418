"""Config registry of the port (``src/repro/configs/__init__.py``).

Every selectable ``--arch`` id maps to a ModelConfig, as in the
reference: its ten ``ASSIGNED`` architectures and the paper's GPT
models, and, apart, the ResNets (``RESNET_REGISTRY``); the dry-run
cells (``cells``, ``skipped_cells``) over ``SHAPES``.
"""
from __future__ import annotations

from repro_torch.configs import resnet50 as _resnet50
from repro_torch.configs.base import (
    DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K, ModelConfig,
    ShapeConfig, vocab_pad,
)
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


def cells(archs=None, shapes=None):
    """All (arch, shape) benchmark cells, honoring long_500k applicability."""
    out = []
    for a in archs or ASSIGNED:
        cfg = get_config(a)
        for s in shapes or SHAPES:
            shp = SHAPES[s]
            if shp.name == "long_500k" and not cfg.long_context_ok:
                continue  # quadratic full-attention arch: documented skip
            out.append((cfg, shp))
    return out


def skipped_cells(archs=None):
    out = []
    for a in archs or ASSIGNED:
        cfg = get_config(a)
        if not cfg.long_context_ok:
            out.append((cfg.name, "long_500k", "full quadratic attention"))
    return out


__all__ = ["ASSIGNED", "DECODE_32K", "LONG_500K", "ModelConfig",
           "PAPER_MODELS", "PREFILL_32K", "REGISTRY", "RESNET_REGISTRY",
           "SHAPES", "ShapeConfig", "TRAIN_4K", "cells", "get_config",
           "skipped_cells", "vocab_pad"]
