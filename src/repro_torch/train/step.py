"""Train-step factories: the language models and ResNet50.

Port of ``src/repro/train/step.py``: the paper's Megatron-style recipe,
bf16 compute with fp32 master weights, activation recomputation per
layer, gradient accumulation over micro-batches. Params stay the
reference's nested dict of tensors (no ``nn.Module``); gradients come
from ``torch.autograd.grad`` over the flattened leaves, taken through
detached aliases that require grad, so the caller's tensors keep their
flags. The reference's ``jax.lax.scan`` over microbatches is a Python
loop here, so its ``unroll`` option has no port. In the place of
``make_train_step``'s sharding arguments (GSPMD grad and batch
constraints) the port's LM step takes a ``plan`` (``parallel.sharding``)
of any layout and the rank's ``zero`` (``sharding.Zero1``) and executes
it explicitly on the mesh's process groups, as GSPMD would partition
the reference's one global program:

  * microbatch ``i`` is global rows ``[i mb, (i+1) mb)`` and the rank
    takes its dp share of them (the reference's ``_split_mb`` and batch
    constraint); each microbatch's loss is its token mean over the
    global microbatch, the tp ranks of a dp rank seeing the same rows;
  * the params are the rank's shards: the model code runs under the
    plan's layout (``parallel.layout``: head, FFN, expert and
    vocabulary splits with Megatron's ``f`` / ``g``, storage-sharded
    leaves gathered per layer, MoE ranking and load balance over the
    global microbatch);
  * ZeRO-2: each microbatch's gradient is reduce-scattered into the
    rank's slice of the fp32 accumulator (``Zero1.reduce_grad``), and
    AdamW updates the slices of its state and gathers the rank's param
    shards; Adafactor updates whole shards with its statistics summed
    over the ranks that cut them.

ResNet's dp step takes its BatchNorm statistics over the ranks too
(``models.resnet``).

The step updates ``params`` and ``opt_state`` in place (see
``train.optimizer``) and returns them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.resnet50 import ResNetConfig
from repro_torch.core import tree
from repro_torch.core.ranges import bracket, span
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import dp_mean
from repro_torch.models import lm, resnet
from repro_torch.parallel import layout as layout_mod
from repro_torch.parallel import sharding as shd
from repro_torch.train.loss import (IGNORE, classification_loss,
                                    next_token_loss)
from repro_torch.train.optimizer import OptConfig, opt_init, opt_update

Params = Any


@dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    impl: str = "repeat"       # attention einsum formulation
    remat: str = "full"        # activation recomputation
    z_coef: float = 0.0
    grad_dtype: str = "float32"  # grad buffer (Megatron bf16-grad option)


def _split_mb(x: torch.Tensor, k: int) -> torch.Tensor:
    return x.reshape(k, x.shape[0] // k, *x.shape[1:])


def value_and_grad(loss_fn: Callable) -> Callable:
    """``vg(params, batch) -> ((loss, aux), grads)`` for a ``loss_fn``
    returning ``(loss, aux)``, as ``jax.value_and_grad(..., has_aux=True)``;
    grads have the params' tree and dtypes, values are detached. Under a
    profiler the call of ``loss_fn`` is the range ``forward`` and every
    backward node of it the range ``backward`` (``core.ranges``)."""
    def vg(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        with torch.enable_grad():
            with span("forward"):
                loss, aux = bracket(
                    "backward",
                    lambda *xs: loss_fn(tree.unflatten(params, xs), batch),
                    *leaves)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        aux = tree.tree_map(torch.Tensor.detach, aux)
        return (loss.detach(), aux), tree.unflatten(params, grads)
    return vg


def scan_microbatch_grads(vg, params, batch: dict, k: int, gdt,
                          *, mb_hook=None, grad_hook=None, acc_hook=None,
                          hook_state=None, init_grads=None):
    """Gradient accumulation over ``k`` microbatches (the reference's
    ``jax.lax.scan``, as a loop).

    ``vg`` is a :func:`value_and_grad`; the per-leaf accumulator dtype is
    ``gdt``. The reference's three hooks:

    - ``mb_hook(mb) -> mb`` transforms each microbatch;
    - ``grad_hook(g, state) -> (g, state)`` runs on each microbatch's raw
      gradients *before* accumulation (the overlapped gradient sync,
      ``parallel.grad_sync``, with its error-feedback state);
    - ``acc_hook(g_acc) -> g_acc`` runs on the running accumulator.

    Returns ``(grads, hook_state, loss, ce, aux)`` — sums over the k
    steps; callers divide by ``k`` themselves.
    """
    mbs = {key: _split_mb(x, k) for key, x in batch.items()}
    g_acc = init_grads
    if g_acc is None:
        g_acc = tree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=gdt, device=p.device),
            params)
    hs = hook_state
    dev = tree.leaves(params)[0].device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    ce = torch.zeros((), dtype=torch.float32, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(k):
        mb = {key: x[i] for key, x in mbs.items()}
        if mb_hook is not None:
            mb = mb_hook(mb)
        (l_i, (ce_i, aux_i)), g = vg(params, mb)
        if grad_hook is not None:
            g, hs = grad_hook(g, hs)
        for a, x in zip(tree.leaves(g_acc), tree.leaves(g), strict=True):
            a.add_(x.to(gdt))
        if acc_hook is not None:
            g_acc = acc_hook(g_acc)
        loss, ce, aux = loss + l_i, ce + ce_i, aux + aux_i
    return g_acc, hs, loss, ce, aux


def make_loss_fn(c: ModelConfig, sc: StepConfig):
    def loss_fn(params: Params, batch: dict):
        logits, aux = lm.forward(c, params, batch["tokens"],
                                 patch_embeds=batch.get("patch_embeds"),
                                 enc_frames=batch.get("enc_frames"),
                                 impl=sc.impl, remat=sc.remat)
        denom = batch.get("token_denom")
        ce = next_token_loss(c, logits, batch["labels"], z_coef=sc.z_coef,
                             denom=None if denom is None
                             else denom.reshape(()))
        total = ce + c.router_aux_coef * aux
        return total, (ce, aux)
    return loss_fn


def _dp_group(plan):
    """The dp process group of an executable plan (None without one)."""
    if plan is None:
        return None
    return plan.mesh.group(plan.dp)


def _local_rows(plan, batch: dict) -> dict:
    return batch if plan is None else shd.local_batch(plan, batch)


def batch_axes(plan, rows: int) -> tuple:
    """The mesh axes (of more than one rank) that cut ``rows`` global
    rows under ``batch_spec``."""
    part = shd.batch_spec(plan, (rows,))[0]
    return tuple(a for a in shd._axes_of(part)
                 if plan.mesh.axes_size(a) > 1)


def make_train_step(c: ModelConfig, oc: OptConfig,
                    sc: StepConfig = StepConfig(), *, plan=None, zero=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``ce``, ``aux``, ``gnorm``, ``lr`` (0-d
    tensors on the params' device).

    Under a ``plan`` the step takes the global batch and trains this
    rank's part of the reference's global step (see the module
    docstring); ``zero`` is the ``Zero1`` layout of its ``params`` (its
    shards) and ``opt_state`` (their ZeRO-1 slices), and a dp plan
    without it (whole params, whole state) builds one."""
    vg = value_and_grad(make_loss_fn(c, sc))
    gdt = getattr(torch, sc.grad_dtype)
    if plan is None:
        def train_step(params: Params, opt_state: Params, batch: dict):
            if sc.microbatches <= 1:
                (loss, (ce, aux)), grads = vg(params, batch)
                grads = tree.tree_map(lambda g: g.to(gdt), grads)
            else:
                k = sc.microbatches
                grads, _, loss, ce, aux = scan_microbatch_grads(
                    vg, params, batch, k, gdt)
                grads = tree.tree_map(lambda g: (g / k).float(), grads)
                loss, ce, aux = loss / k, ce / k, aux / k
            new_params, new_state, info = opt_update(oc, grads, opt_state,
                                                     params)
            metrics = {"loss": loss, "ce": ce, "aux": aux, **info}
            return new_params, new_state, metrics
        return train_step

    k = max(sc.microbatches, 1)
    memo: dict = {}         # the Zero1 built for whole params; layouts

    def microbatches(batch: dict):
        """``(rows, axes, global token count)`` of each microbatch: its
        global rows ``[i mb, (i+1) mb)`` counted whole (every rank holds
        them) and cut to this rank's share."""
        rows = batch["tokens"].shape[0] // k
        axes = batch_axes(plan, rows)
        out = []
        for i in range(k):
            mb = {key: x[i * rows:(i + 1) * rows] for key, x in batch.items()}
            n = (mb["labels"] != IGNORE).sum(dtype=torch.float32)
            out.append((shd.local_batch(plan, mb), axes, n))
        return out

    def zero_of(params):
        if zero is not None:
            return zero
        if "zero" not in memo:
            memo["zero"] = shd.Zero1(plan, params, c)
        return memo["zero"]

    sliced = zero is not None and oc.name == "adamw"

    def grads_fn(params: Params, batch: dict):
        """``(grads, ce, aux)``: the step's reduced gradients (this
        rank's ZeRO slices when ``zero`` is given and the optimizer is
        AdamW, else its shards, whole over the batch ranks) and the
        global CE and aux, averaged over the microbatches."""
        z = zero_of(params)
        dev = tree.leaves(params)[0].device
        acc = None
        ce = torch.zeros((), dtype=torch.float32, device=dev)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for mb, axes, n in microbatches(batch):
            if axes not in memo:
                memo[axes] = z.layout(axes)
            mb = dict(mb, token_denom=n.clamp_min(1.0))
            with layout_mod.use(memo[axes]):
                (_l, (ce_i, aux_i)), g = vg(params, mb)
            with span("grad_sync"):
                g = [z.reduce_grad(i, x.to(gdt), axes, zero=sliced)
                     for i, x in enumerate(tree.leaves(g))]
            if acc is None:
                acc = g
            else:
                for a, x in zip(acc, g, strict=True):
                    a.add_(x)
            # each rank's CE covers its rows; aux is the global one
            ce = ce + (plan.mesh.all_reduce(ce_i, axes) if axes else ce_i)
            aux = aux + aux_i
        grads = tree.unflatten(params, [(a / k).float() if k > 1
                                        else a.float() for a in acc])
        return grads, ce / k, aux / k

    def train_step(params: Params, opt_state: Params, batch: dict):
        grads, ce, aux = grads_fn(params, batch)
        loss = ce + c.router_aux_coef * aux
        if oc.name == "adamw":     # slices (zero given) or whole grads
            new_params, new_state, info = opt_update(
                oc, grads, opt_state, params, zero, sharded=sliced)
        else:                      # shards, statistics across the ranks
            new_params, new_state, info = opt_update(
                oc, grads, opt_state, params, zero_of(params), sharded=True)
        metrics = {"loss": loss, "ce": ce, "aux": aux, **info}
        return new_params, new_state, metrics

    train_step.grads = grads_fn
    return train_step


# ---------------------------------------------------------------------------
# ResNet50 (data-parallel: the Horovod-analog all-reduce)
# ---------------------------------------------------------------------------


def make_resnet_train_step(c: ResNetConfig, oc: OptConfig, *, plan=None,
                           zero=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` over ``batch = {"images": (B, H, W, 3), "labels": (B,)}``:
    the classification loss, gradients cast to fp32, one optimizer
    update in place; metrics ``loss``, ``gnorm``, ``lr``. Under a dp
    ``plan`` each rank trains on its rows of the global batch with
    BatchNorm's statistics over every rank's rows, the gradients are
    all-reduced to their mean and ``zero`` is the ZeRO-1 layout of
    ``opt_state``."""
    group = _dp_group(plan)

    def loss_fn(params, batch):
        logits = resnet.forward(c, params, batch["images"],
                                stats_group=group)
        return classification_loss(logits, batch["labels"]), ()

    vg = value_and_grad(loss_fn)

    def train_step(params, opt_state, batch):
        (loss, _), grads = vg(params, _local_rows(plan, batch))
        grads = tree.tree_map(lambda g: g.float(), grads)
        if group is not None:
            grads, (loss,) = dp_mean(grads, [loss], group)
        new_params, new_state, info = opt_update(oc, grads, opt_state,
                                                 params, zero)
        return new_params, new_state, {"loss": loss, **info}

    return train_step


def init_train_state(c, oc: OptConfig,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None):
    """``(params, opt_state)`` from the port's seeded initializer
    (``lm.init``, or ``resnet.init`` for a ``ResNetConfig``) on
    ``device`` (default the card)."""
    if isinstance(c, ResNetConfig):
        p = resnet.init(c, generator, resolve_device(device))
    elif isinstance(c, ModelConfig):
        p = lm.init(c, generator, resolve_device(device))
    else:
        raise TypeError(f"{type(c).__name__}: expected a ModelConfig or a "
                        "ResNetConfig")
    return p, opt_init(oc, p)
