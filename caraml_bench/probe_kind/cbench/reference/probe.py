"""Plain reference of the probe MLP: loss and gradients in float32.

The images (N, H, W, 3) flattened, a product, its bias and ReLU, a
second product and its bias; the mean cross-entropy.
"""
from __future__ import annotations

import torch

from cbench.reference.lowp import Precision


def loss_and_grads(cfg, P: dict, batch: dict, prec: Precision,
                   remat: bool = True):
    """``(mean loss, {name: gradient})`` of one step's batch."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in P.items()}
    with torch.enable_grad():
        images = batch["images"].float()
        x = images.reshape(images.shape[0], -1)
        h = torch.relu(prec.mm(x, leaves["w1"]) + leaves["b1"])
        logits = prec.mm(h, leaves["w2"]) + leaves["b2"]
        labels = batch["labels"].long()
        loss = (torch.logsumexp(logits, -1)
                - logits.gather(-1, labels[:, None])[:, 0]).mean()
        gs = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, gs))
