"""A probe model kind (``arch: "probe"``): a two-layer MLP classifier
over flattened images, trained by the port's AdamW
(``repro_torch.train.optimizer``) through the port's ``value_and_grad``.
It stands for a kind the benchmark does not have yet, and joins a copy
of the benchmark with new files only (``test_cb_newkind.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from cbench import weights

ITEMS = "images"
#: the configuration and traffic keys a CPU test overrides
TINY = dict(img_size=8, hidden=32, n_classes=16)
TINY_TRAFFIC = dict(global_batch=8)


def leaf_specs(cfg: dict) -> list:
    """``(name, shape, mean, std)``: He-normal matrices, biases at 0.02."""
    d, h, c = 3 * cfg["img_size"] ** 2, cfg["hidden"], cfg["n_classes"]
    return [("w1", (d, h), 0.0, (2.0 / d) ** 0.5), ("b1", (h,), 0.0, 0.02),
            ("w2", (h, c), 0.0, (1.0 / h) ** 0.5), ("b2", (c,), 0.0, 0.02)]


def forward(p: dict, images: torch.Tensor) -> torch.Tensor:
    x = images.reshape(images.shape[0], -1).to(p["w1"].dtype)
    h = torch.relu(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


class Program:
    """The MLP's train step with its params and the port's optimizer
    state."""

    def __init__(self, cfg: dict, traffic: dict, named: dict, device):
        from repro_torch.train.loss import classification_loss
        from repro_torch.train.optimizer import OptConfig, opt_init
        from repro_torch.train.step import value_and_grad
        names = {f.name for f in dataclasses.fields(OptConfig)}
        self.oc = OptConfig(**{k: v for k, v in cfg["optimizer"].items()
                               if k in names},
                            master_dtype=cfg["master_dtype"])
        self.params = weights.nest(named)
        self.opt_state = opt_init(self.oc, self.params)
        self._vg = value_and_grad(lambda p, b: (classification_loss(
            forward(p, b["images"]), b["labels"]), ()))

    def step(self, batch: dict) -> dict:
        from repro_torch.train.optimizer import opt_update
        (loss, _), grads = self._vg(self.params, batch)
        grads = {n: g.float() for n, g in grads.items()}
        self.params, self.opt_state, info = opt_update(
            self.oc, grads, self.opt_state, self.params)
        return {"loss": loss, **info}

    def first_moments(self) -> dict:
        return weights.flat(self.opt_state["m"])

    def masters(self) -> dict:
        return weights.flat(self.opt_state["master"])
