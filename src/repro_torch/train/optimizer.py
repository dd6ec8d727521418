"""Optimizers: AdamW with fp32 master weights (Megatron mixed precision)
and Adafactor (factored second moment).

Port of ``src/repro/train/optimizer.py``. Same configuration, schedule
and arithmetic, op for op: the step count, ``lr`` and the bias
corrections are fp32 tensors, as in the reference (Python floats would
be float64); decoupled weight decay applies to every leaf with
``ndim >= 1``, which with layer-stacked leaves includes the ``(L, D)``
norm scales and biases (the reference's choice, kept); new params are
the master weights cast to the params' dtype.

The reference returns new trees; the port updates ``params`` and the
optimizer state in place under ``torch.no_grad()``, one leaf at a time
(the PyTorch idiom: no second copy of the state), and returns the same
objects. A caller that must keep a state across a step (a checkpoint
snapshot, a test) copies it first. AdamW updates a leaf larger than
``UPDATE_PIECE`` elements in pieces along its first axis: its
arithmetic is elementwise, so the result is the same to the bit, and
its fp32 temporaries stay a piece's size however large the stacked
leaf (a layer-stacked expert weight of granite-moe-3b-a800m is 8 GB in
fp32, and each of its half-dozen temporaries would be as large). Under a
data-parallel plan AdamW's state holds this rank's ZeRO-1 slices (the
reference's ``opt_state_shardings``), which ``adamw_update`` updates
from the full synced gradient before gathering each parameter.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.profiler import record_function

from repro_torch.core import tree

Params = Any


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # "adamw" | "adafactor"
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_dtype: str = "float32"


def lr_at(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay (Megatron's default schedule)."""
    s = step.float()
    warm = torch.clamp(s / max(oc.warmup, 1), max=1.0)
    t = torch.clamp((s - oc.warmup) / max(oc.total_steps - oc.warmup, 1),
                    0, 1)
    cos = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return oc.lr * warm * cos


#: elements of the largest piece of a leaf that AdamW updates at once
UPDATE_PIECE = 1 << 27


def _pieces(*leaves: torch.Tensor):
    """Views of same-shaped ``leaves``, split together along their first
    axis into pieces of at most ``UPDATE_PIECE`` elements (one row at
    least); the leaves whole when they are small or 0-d."""
    t = leaves[0]
    if t.ndim == 0 or t.numel() <= UPDATE_PIECE:
        return [leaves]
    rows = max(1, UPDATE_PIECE // (t.numel() // t.shape[0]))
    return zip(*(x.split(rows) for x in leaves))


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.leaves(grads)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree.tree_map(lambda g: g.float() * scale, grads), gn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _device(params) -> torch.device:
    return tree.leaves(params)[0].device


def adamw_init(oc: OptConfig, params: Params) -> Params:
    md = getattr(torch, oc.master_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
        "m": tree.tree_map(zeros, params),
        "v": tree.tree_map(zeros, params),
        "master": tree.tree_map(lambda p: p.detach().to(md, copy=True),
                                params),
    }


@torch.no_grad()
def adamw_update(oc: OptConfig, grads: Params, state: Params,
                 params: Params, zero=None):
    """One AdamW step in place. With ``zero`` (a
    ``parallel.sharding.Zero1``) ``m`` / ``v`` / ``master`` hold this
    rank's ZeRO-1 slices: the rank updates its slice of each parameter
    from the full (synced) gradient, and the slices are gathered into
    the full parameter. The clip's global norm is the full gradient's."""
    gs = tree.leaves(grads)
    gnorm = global_norm(gs)
    scale = _clip_scale(gnorm, oc.grad_clip)
    step = state["step"] + 1
    lr = lr_at(oc, step)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for i, (g, m, v, master, p) in enumerate(zip(
            gs, tree.leaves(state["m"]), tree.leaves(state["v"]),
            tree.leaves(state["master"]), tree.leaves(params), strict=True)):
        sliced = zero is not None and zero.cuts[i]
        if sliced:
            full, g = p, zero.local(i, g)
            p = torch.empty(master.shape, dtype=full.dtype,
                            device=full.device)
        for gp, mp, vp, masterp, pp in _pieces(g, m, v, master, p):
            gp = gp.float() * scale
            mp.mul_(b1).add_((1 - b1) * gp)
            vp.mul_(b2).add_((1 - b2) * torch.square(gp))
            delta = (mp / bc1).div_(torch.sqrt(vp / bc2).add_(oc.eps))
            if masterp.ndim >= 1:  # decoupled weight decay, skip scalars
                delta.add_(oc.weight_decay * masterp)
            masterp.sub_(lr * delta)
            pp.copy_(masterp)
        if sliced:
            full.copy_(zero.gather(i, p))
    state["step"] = step
    return params, state, {"gnorm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Adafactor (factored v, no master copy) — memory-lean fallback
# ---------------------------------------------------------------------------


def adafactor_init(oc: OptConfig, params: Params) -> Params:
    def rows(p):
        shape = p.shape if p.ndim < 2 else p.shape[:-1]
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def cols(p):
        shape = () if p.ndim < 2 else p.shape[:-2] + p.shape[-1:]
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32,
                                device=_device(params)),
            "vr": tree.tree_map(rows, params),
            "vc": tree.tree_map(cols, params)}


@torch.no_grad()
def adafactor_update(oc: OptConfig, grads: Params, state: Params,
                     params: Params):
    gs = tree.leaves(grads)
    gnorm = global_norm(gs)
    scale = _clip_scale(gnorm, oc.grad_clip)
    step = state["step"] + 1
    lr = lr_at(oc, step)
    decay = 1.0 - (step.float() + 1.0) ** -0.8
    for g, vr, vc, p in zip(gs, tree.leaves(state["vr"]),
                            tree.leaves(state["vc"]), tree.leaves(params),
                            strict=True):
        g = g.float() * scale
        g2 = torch.square(g) + 1e-30
        if p.ndim < 2:
            vr.copy_(decay * vr + (1 - decay) * g2)
            update = g * torch.rsqrt(vr + 1e-30)
            p.copy_(p.float() - lr * update)
            continue
        vr.copy_(decay * vr + (1 - decay) * g2.mean(-1))
        vc.copy_(decay * vc + (1 - decay) * g2.mean(-2))
        r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
        update = g * torch.rsqrt(r[..., None] * vc[..., None, :] + 1e-30)
        pf = p.float()
        p.copy_(pf - lr * (update + oc.weight_decay * pf))
    state["step"] = step
    return params, state, {"gnorm": gnorm, "lr": lr}


def opt_init(oc: OptConfig, params):
    return adamw_init(oc, params) if oc.name == "adamw" \
        else adafactor_init(oc, params)


def opt_update(oc: OptConfig, grads, state, params, zero=None):
    """One optimizer step, in place; ``(params, state, {"gnorm", "lr"})``.
    ``zero`` (AdamW only) names the ZeRO-1 slices the state holds;
    Adafactor's factored state replicates, as in the reference."""
    with record_function("optimizer"):
        if oc.name == "adamw":
            return adamw_update(oc, grads, state, params, zero)
        return adafactor_update(oc, grads, state, params)
