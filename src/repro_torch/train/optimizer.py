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
optimizer state in place under ``torch.no_grad()`` (the PyTorch idiom:
no second copy of the state), and returns the same objects. A caller
that must keep a state across a step (a checkpoint snapshot, a test)
copies it first. On the card AdamW updates every leaf in one
hand-written multi-tensor pass (``kernels/adamw.py``: a norm, a
finalize and an update launch, no temporaries, no host synchronise);
elsewhere its plain version :func:`adamw_leaves_ref` goes one leaf at a
time, the same arithmetic op for op. The plain loop updates a leaf
larger than ``UPDATE_PIECE`` elements in pieces along its first axis:
its arithmetic is elementwise, so the result is the same to the bit,
and its fp32 temporaries stay a piece's size however large the stacked
leaf (a layer-stacked expert weight of granite-moe-3b-a800m is 8 GB in
fp32, and each of its half-dozen temporaries would be as large). Under a
plan AdamW's state holds this rank's ZeRO-1 slices of its param shards
(the reference's ``opt_state_shardings``, ``parallel.sharding.Zero1``),
which ``adamw_update`` updates from the synced gradient (whole, as the
bucketed dp step gives it, or already the rank's slice, ZeRO-2, with
``sharded=True``) before gathering each parameter shard. With
``sharded=True`` the clip's global norm sums every rank's squares once
per element (a replicated element is counted once, not once a rank) and
Adafactor's row and column statistics of a leaf cut on a factored dim
are summed over the ranks that cut it, so the update is the reference's
on the whole leaves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core import tree
from repro_torch.core.ranges import span
from repro_torch.kernels.adamw import adamw as adamw_kernel

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


def global_norm(grads, zero=None, sliced: bool = True) -> torch.Tensor:
    """The gradients' global L2 norm. With ``zero`` (a
    ``parallel.sharding.Zero1``) the leaves are this rank's parts (ZeRO
    slices with ``sliced``, else shards): each leaf's squares are divided
    by the ranks holding the same elements and summed over the world."""
    gs = tree.leaves(grads)
    if zero is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in gs))
    sq = sum(torch.sum(torch.square(g.float())) / zero.replicas(i, sliced)
             for i, g in enumerate(gs))
    return torch.sqrt(zero.mesh.all_reduce(sq, zero.mesh.axis_names))


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


def _zero_leaves(gs: list, masters: list, ps: list, zero,
                 sharded: bool) -> tuple:
    """The update's gradients and params under a ZeRO layout ``zero``: a
    leaf it cuts takes this rank's slice of its gradient (the gradient
    is that slice already with ``sharded``) and a new buffer of the
    param's type in the slice's shape, which :func:`_zero_gather` puts
    back into the param. Without ``zero``, the leaves as they are."""
    if zero is None or not any(zero.cuts):
        return gs, ps
    cut = zero.cuts
    ug = [zero.local(i, g) if cut[i] and not sharded else g
          for i, g in enumerate(gs)]
    up = [torch.empty(w.shape, dtype=p.dtype, device=p.device) if cut[i]
          else p for i, (w, p) in enumerate(zip(masters, ps))]
    return ug, up


def _zero_gather(ps: list, up: list, zero) -> None:
    """Each updated slice of :func:`_zero_leaves` gathered into its
    param."""
    if up is not ps:
        for i, cut in enumerate(zero.cuts):
            if cut:
                ps[i].copy_(zero.gather(i, up[i]))


def adamw_leaves_ref(oc: OptConfig, gs: list, ms: list, vs: list,
                     masters: list, ps: list, lr: torch.Tensor,
                     bc1: torch.Tensor, bc2: torch.Tensor, zero=None,
                     sharded: bool = False) -> torch.Tensor:
    """The plain version of the AdamW kernel (``kernels/adamw.py``): the
    clip's global norm, then each leaf in turn (in pieces of at most
    ``UPDATE_PIECE`` elements), in place; returns the norm. The leaves
    are :func:`adamw_update`'s, flattened."""
    gnorm = global_norm(gs, zero if sharded else None)
    scale = _clip_scale(gnorm, oc.grad_clip)
    b1, b2 = oc.b1, oc.b2
    ug, up = _zero_leaves(gs, masters, ps, zero, sharded)
    for g, m, v, master, p in zip(ug, ms, vs, masters, up, strict=True):
        for gp, mp, vp, masterp, pp in _pieces(g, m, v, master, p):
            gp = gp.float() * scale
            mp.mul_(b1).add_((1 - b1) * gp)
            vp.mul_(b2).add_((1 - b2) * torch.square(gp))
            delta = (mp / bc1).div_(torch.sqrt(vp / bc2).add_(oc.eps))
            if masterp.ndim >= 1:  # decoupled weight decay, skip scalars
                delta.add_(oc.weight_decay * masterp)
            masterp.sub_(lr * delta)
            pp.copy_(masterp)
    _zero_gather(ps, up, zero)
    return gnorm


def _adamw_card(oc: OptConfig, gs: list, ms: list, vs: list, masters: list,
                ps: list, lr: torch.Tensor, bc1: torch.Tensor,
                bc2: torch.Tensor, zero=None,
                sharded: bool = False) -> torch.Tensor:
    """:func:`adamw_leaves_ref` on the card: every leaf in one call of
    the multi-tensor kernel, the ZeRO slices written into buffers of the
    params' type and gathered after it."""
    ug, up = _zero_leaves(gs, masters, ps, zero, sharded)
    divisors = reduce = None
    if zero is not None and sharded:
        divisors = [zero.replicas(i) for i in range(len(gs))]
        reduce = lambda sq: zero.mesh.all_reduce(  # noqa: E731
            sq, zero.mesh.axis_names)
    gnorm = adamw_kernel(gs, ug, ms, vs, masters, up, lr=lr, bc1=bc1,
                         bc2=bc2, b1=oc.b1, b2=oc.b2, eps=oc.eps,
                         weight_decay=oc.weight_decay, clip=oc.grad_clip,
                         norm_divisors=divisors, reduce=reduce)
    _zero_gather(ps, up, zero)
    return gnorm


@torch.no_grad()
def adamw_update(oc: OptConfig, grads: Params, state: Params,
                 params: Params, zero=None, sharded: bool = False):
    """One AdamW step in place: on the card the multi-tensor kernel,
    elsewhere (CPU, meta) the plain per-leaf loop. With ``zero`` (a
    ``parallel.sharding.Zero1``) ``m`` / ``v`` / ``master`` hold this
    rank's ZeRO-1 slices: the rank updates its slice of each parameter
    from the synced gradient (whole, or its slice with ``sharded``), and
    the slices are gathered into the rank's parameter shard. The clip's
    global norm is the whole gradient's."""
    gs = tree.leaves(grads)
    step = state["step"] + 1
    lr = lr_at(oc, step)
    bc1 = 1 - oc.b1 ** step.float()
    bc2 = 1 - oc.b2 ** step.float()
    update = _adamw_card if gs[0].device.type == "cuda" \
        else adamw_leaves_ref
    gnorm = update(oc, gs, tree.leaves(state["m"]), tree.leaves(state["v"]),
                   tree.leaves(state["master"]), tree.leaves(params), lr,
                   bc1, bc2, zero, sharded)
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


def _mean(x: torch.Tensor, dim: int, zero, i: int, leaf_dim: int,
          keepdim: bool = False):
    """``x.mean(dim)`` over the whole extent of leaf ``i``'s dim
    ``leaf_dim`` (-1 its columns, -2 its rows), which ``x``'s ``dim``
    runs along: with ``zero``, a sum over the ranks that cut it."""
    axes = () if zero is None else tuple(
        a for d, a, *_k in zero.param_cuts[i]
        if d == zero.ndims[i] + leaf_dim)
    if not axes:
        return x.mean(dim, keepdim=keepdim)
    n = x.shape[dim] * zero.mesh.axes_size(axes)
    return zero.mesh.all_reduce(x.sum(dim, keepdim=keepdim), axes) / n


@torch.no_grad()
def adafactor_update(oc: OptConfig, grads: Params, state: Params,
                     params: Params, zero=None):
    """One Adafactor step in place; with ``zero`` the leaves are this
    rank's shards and their row and column statistics are summed over
    the ranks that cut them."""
    gs = tree.leaves(grads)
    gnorm = global_norm(gs, zero, sliced=False)
    scale = _clip_scale(gnorm, oc.grad_clip)
    step = state["step"] + 1
    lr = lr_at(oc, step)
    decay = 1.0 - (step.float() + 1.0) ** -0.8
    for i, (g, vr, vc, p) in enumerate(zip(
            gs, tree.leaves(state["vr"]), tree.leaves(state["vc"]),
            tree.leaves(params), strict=True)):
        g = g.float() * scale
        g2 = torch.square(g) + 1e-30
        if p.ndim < 2:
            vr.copy_(decay * vr + (1 - decay) * g2)
            update = g * torch.rsqrt(vr + 1e-30)
            p.copy_(p.float() - lr * update)
            continue
        vr.copy_(decay * vr + (1 - decay) * _mean(g2, -1, zero, i, -1))
        vc.copy_(decay * vc + (1 - decay) * _mean(g2, -2, zero, i, -2))
        # vr runs along the leaf's rows
        r = vr / torch.clamp(_mean(vr, -1, zero, i, -2, keepdim=True),
                             min=1e-30)
        update = g * torch.rsqrt(r[..., None] * vc[..., None, :] + 1e-30)
        pf = p.float()
        p.copy_(pf - lr * (update + oc.weight_decay * pf))
    state["step"] = step
    return params, state, {"gnorm": gnorm, "lr": lr}


def opt_init(oc: OptConfig, params):
    return adamw_init(oc, params) if oc.name == "adamw" \
        else adafactor_init(oc, params)


def opt_update(oc: OptConfig, grads, state, params, zero=None,
               sharded: bool = False):
    """One optimizer step, in place; ``(params, state, {"gnorm", "lr"})``.
    ``zero`` names the layout the state holds (AdamW's ZeRO-1 slices);
    ``sharded``: the gradients are this rank's parts (AdamW: its ZeRO
    slices; Adafactor: its shards), reduced across the ranks as
    :func:`global_norm` and the factored statistics need."""
    with span("optimizer"):
        if oc.name == "adamw":
            return adamw_update(oc, grads, state, params, zero, sharded)
        return adafactor_update(oc, grads, state, params,
                                zero if sharded else None)
