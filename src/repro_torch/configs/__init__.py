"""Config registry of the port (``src/repro/configs/__init__.py``).

Only the architectures the port can run are registered: the dense
decoders ``llama3.2-3b`` (the serve path) and the paper's GPT models.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, vocab_pad
from repro_torch.configs.gpt_models import GPT_117M, GPT_800M, GPT_13B, GPT_175B
from repro_torch.configs.llama3_2_3b import CONFIG as _llama3_2_3b

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in (_llama3_2_3b, GPT_117M, GPT_800M, GPT_13B, GPT_175B)
}


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(REGISTRY)}"
        ) from None


__all__ = ["ModelConfig", "REGISTRY", "get_config", "vocab_pad"]
