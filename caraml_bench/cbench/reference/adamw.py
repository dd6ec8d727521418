"""AdamW with fp32 state, as the configuration's ``optimizer`` states it,
and the reference's first steps with the readings the check compares.

The schedule is linear warm-up then cosine decay to ``min_lr_frac``
(``lr * min(t / warmup, 1) * (f + (1 - f) (1 + cos(pi u)) / 2)``, ``u``
the share of the steps after warm-up, clamped to [0, 1]); the
gradients are clipped to a global norm of ``grad_clip``; the moments
are bias-corrected; weight decay is decoupled and applies to every leaf.
"""
from __future__ import annotations

import math

import torch


def lr_at(opt: dict, t: int) -> float:
    warm = min(t / max(opt["warmup"], 1), 1.0)
    u = min(max((t - opt["warmup"])
                / max(opt["total_steps"] - opt["warmup"], 1), 0.0), 1.0)
    f = opt["min_lr_frac"]
    return opt["lr"] * warm * (f + (1 - f) * 0.5 * (1 + math.cos(math.pi * u)))


def follow(loss_and_grads, P0: dict, batches: list, opt: dict,
           vectors: bool = False, frozen: bool = False) -> dict:
    """Train float32 copies of ``P0`` on ``batches``, one step each:
    ``{"losses": [each step's loss], "grad": {leaf: norm of the first
    step's gradient}, "change": {leaf: norm of the params' change after
    the last step}}``, with ``vectors`` also ``"grad_vec"``, the first
    gradient itself. ``loss_and_grads(P, batch) -> (loss, grads)``.
    ``frozen`` plants the fault of a step that returns its state
    unchanged: the losses are taken, the state (moments, params) never
    moves."""
    P = {n: p.detach().float().clone() for n, p in P0.items()}
    m = {n: torch.zeros_like(p) for n, p in P.items()}
    v = {n: torch.zeros_like(p) for n, p in P.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    out = {"losses": []}
    for t, batch in enumerate(batches, start=1):
        loss, g = loss_and_grads(P, batch)
        out["losses"].append(float(loss))
        if frozen:
            g = {n: torch.zeros_like(x) for n, x in g.items()}
        if t == 1:
            out["grad"] = {n: float(x.norm()) for n, x in g.items()}
            if vectors:
                out["grad_vec"] = g
        if frozen:
            continue
        gn = math.sqrt(sum(float(x.square().sum()) for x in g.values()))
        scale = min(opt["grad_clip"] / max(gn, 1e-12), 1.0)
        lr = lr_at(opt, t)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        with torch.no_grad():
            for n, p in P.items():
                gs = g[n] * scale
                m[n].mul_(b1).add_(gs, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(gs, gs, value=1 - b2)
                delta = (m[n] / bc1) / ((v[n] / bc2).sqrt() + eps)
                p.sub_(lr * (delta + opt["weight_decay"] * p))
        del g
    out["change"] = {n: float((P[n] - P0[n].float()).norm()) for n in P}
    return out
