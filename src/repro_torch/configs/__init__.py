"""Config registry of the port (``src/repro/configs/__init__.py``).

Only the architectures the port can run are registered: the dense
decoders ``llama3.2-3b`` (the serve path) and the paper's GPT models,
and, apart as in the reference, the ResNets (``RESNET_REGISTRY``).
"""
from __future__ import annotations

from repro_torch.configs import resnet50 as _resnet50
from repro_torch.configs.base import ModelConfig, vocab_pad
from repro_torch.configs.gpt_models import GPT_117M, GPT_800M, GPT_13B, GPT_175B
from repro_torch.configs.llama3_2_3b import CONFIG as _llama3_2_3b

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in (_llama3_2_3b, GPT_117M, GPT_800M, GPT_13B, GPT_175B)
}

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


__all__ = ["ModelConfig", "REGISTRY", "RESNET_REGISTRY", "get_config",
           "vocab_pad"]
