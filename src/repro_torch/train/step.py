"""Train-step factories for the language models.

Port of ``src/repro/train/step.py``: the paper's Megatron-style recipe,
bf16 compute with fp32 master weights, activation recomputation per
layer, gradient accumulation over micro-batches. Params stay the
reference's nested dict of tensors (no ``nn.Module``); gradients come
from ``torch.autograd.grad`` over the flattened leaves, taken through
detached aliases that require grad, so the caller's tensors keep their
flags. The reference's ``jax.lax.scan`` over microbatches is a Python
loop here, so its ``unroll`` option has no port; nor have
``make_train_step``'s sharding arguments (GSPMD grad and batch
constraints): multi-device placement is ROADMAP Queue 1 item 8. The
ResNet step waits for Queue 1 item 7.

The step updates ``params`` and ``opt_state`` in place (see
``train.optimizer``) and returns them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.train.loss import next_token_loss
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
    grads have the params' tree and dtypes, values are detached."""
    def vg(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        with torch.enable_grad(), record_function("forward_backward"):
            loss, aux = loss_fn(tree.unflatten(params, leaves), batch)
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
        logits, aux = lm.forward(c, params, batch["tokens"], impl=sc.impl,
                                 remat=sc.remat)
        ce = next_token_loss(c, logits, batch["labels"], z_coef=sc.z_coef)
        total = ce + c.router_aux_coef * aux
        return total, (ce, aux)
    return loss_fn


def make_train_step(c: ModelConfig, oc: OptConfig,
                    sc: StepConfig = StepConfig()):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``ce``, ``aux``, ``gnorm``, ``lr`` (0-d
    tensors on the params' device)."""
    vg = value_and_grad(make_loss_fn(c, sc))
    gdt = getattr(torch, sc.grad_dtype)

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


def init_train_state(c, oc: OptConfig,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None):
    """``(params, opt_state)`` from the port's seeded initializer
    (``lm.init``) on ``device`` (default the card)."""
    if not isinstance(c, ModelConfig):
        raise NotImplementedError(
            f"{type(c).__name__}: the ResNet train step is not ported: "
            "ROADMAP Queue 1 item 7")
    p = lm.init(c, generator, resolve_device(device))
    return p, opt_init(oc, p)
