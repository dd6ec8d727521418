"""Decoder-only language models (``arch: "lm"``) on the port's one-rank
train step, ``repro_torch.train.step.make_train_step``: what
``python -m repro_torch.launch.train`` runs at dp1.

The configuration file's keys that ``ModelConfig``, ``OptConfig`` and
``StepConfig`` know are passed through as they are. The weights are the
benchmark's (``leaf_specs``): the port's tree, every leaf drawn from the
seed, and the port makes its optimizer state from them with its own
``opt_init``.
"""
from __future__ import annotations

import dataclasses

import torch

from cbench import weights

ITEMS = "tokens"
#: the configuration and traffic keys a CPU test overrides: a size at
#: which a step runs in a second there
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
            d_ff=128, vocab=500)
TINY_TRAFFIC = dict(seq_len=32, global_batch=4, microbatches=2)


def padded_vocab(cfg: dict, multiple: int = 256) -> int:
    return -(-cfg["vocab"] // multiple) * multiple


def leaf_specs(cfg: dict) -> list:
    """``(name, shape, mean, std)`` of every leaf of the port's dense
    tree, at Megatron's init: matrices and the embedding at 0.02, the
    two output projections of each block at 0.02 / sqrt(2 L); biases at
    0.02 around 0 and norm scales at 0.02 around 1 (random, not 0 and 1,
    so that every term of the layers is exercised from the first
    step)."""
    if cfg["family"] != "dense" or not cfg["tie_embeddings"]:
        raise ValueError("the lm model kind covers dense models with tied "
                         "embeddings")
    L, D, F = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    H, Kh = cfg["n_heads"], cfg["n_kv_heads"]
    Dh = cfg.get("d_head") or D // H
    s = "layers.slot0."
    specs = [("embed.tok", (padded_vocab(cfg), D), 0.0, 0.02)]
    norms = ["norm1", "norm2"]
    for n in norms:
        specs.append((s + n + ".scale", (L, D), 1.0, 0.02))
        if cfg["norm"] == "layernorm":
            specs.append((s + n + ".bias", (L, D), 0.0, 0.02))
    std, out_std = 0.02, 0.02 / (2 * L) ** 0.5
    specs += [(s + "attn.wq", (L, D, H, Dh), 0.0, std),
              (s + "attn.wk", (L, D, Kh, Dh), 0.0, std),
              (s + "attn.wv", (L, D, Kh, Dh), 0.0, std),
              (s + "attn.wo", (L, H, Dh, D), 0.0, out_std)]
    if cfg["qkv_bias"]:
        specs += [(s + "attn.bq", (L, H, Dh), 0.0, 0.02),
                  (s + "attn.bk", (L, Kh, Dh), 0.0, 0.02),
                  (s + "attn.bv", (L, Kh, Dh), 0.0, 0.02)]
    if cfg["act"] != "gelu":
        raise ValueError("the lm model kind covers the GELU MLP")
    specs += [(s + "mlp.wi", (L, D, F), 0.0, std),
              (s + "mlp.wo", (L, F, D), 0.0, out_std)]
    if cfg["mlp_bias"]:
        specs += [(s + "mlp.bi", (L, F), 0.0, 0.02),
                  (s + "mlp.bo", (L, D), 0.0, 0.02)]
    specs.append(("final_norm.scale", (D,), 1.0, 0.02))
    if cfg["norm"] == "layernorm":
        specs.append(("final_norm.bias", (D,), 0.0, 0.02))
    return specs


def _known(cls, cfg: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in cfg.items() if k in names}


def port_configs(cfg: dict, traffic: dict):
    """``(ModelConfig, OptConfig, StepConfig)`` of the port, from the
    configuration and traffic files."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import StepConfig
    c = ModelConfig(**_known(ModelConfig, cfg))
    oc = OptConfig(**_known(OptConfig, cfg["optimizer"]),
                   master_dtype=cfg["master_dtype"])
    sc = StepConfig(microbatches=int(traffic["microbatches"]),
                    impl=cfg["attention_impl"], remat=cfg["remat"])
    return c, oc, sc


class Program:
    """The port's train step with its params and optimizer state."""

    def __init__(self, cfg: dict, traffic: dict, named: dict, device):
        from repro_torch.train.optimizer import opt_init
        from repro_torch.train.step import make_train_step
        c, oc, sc = port_configs(cfg, traffic)
        self.params = weights.nest(named)
        self.opt_state = opt_init(oc, self.params)
        self._step = make_train_step(c, oc, sc)

    def step(self, batch: dict) -> dict:
        self.params, self.opt_state, m = self._step(self.params,
                                                    self.opt_state, batch)
        return m

    def first_moments(self) -> dict:
        return weights.flat(self.opt_state["m"])

    def masters(self) -> dict:
        return weights.flat(self.opt_state["master"])
