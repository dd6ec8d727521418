"""Named profiler ranges of the port: forward, backward and per-layer.

The port marks its layers for ``torch.profiler`` with two helpers that
cost one check of the profiler's flag when no profiler is active:

  * :func:`span` opens a ``record_function`` range around a block on the
    calling thread, and is a shared no-op context otherwise.
  * :func:`bracket` puts a range around the *backward* of what ``fn``
    computes. While a profiler is active, a pre-hook on the node that
    made each tensor of ``fn``'s result opens the range, and the first
    hook on the gradient of a bracketed tensor that some node computed
    closes it. When every bracketed tensor is a leaf (its gradient
    comes from no node, and hooks on leaves do not run under
    ``torch.autograd.grad``), an identity over them (:class:`_Close`)
    closes it in its backward instead. The hooks and the identity's
    backward run on the thread that autograd runs those nodes on (on a
    CUDA card a worker thread of the engine, not the caller's), so a
    reader that matches launches to ranges by thread finds the
    backward's kernels inside the range. Untraced, nothing is
    registered and the autograd graph is the plain one.

The hooks return nothing, so the gradients are the plain ones. The
identity returns views and passes the gradients through: every number
stays the same to the bit where each bracketed leaf has one use inside
``fn`` or none outside it, as in the port's brackets (a leaf with
several uses inside and others outside would have its gradient's terms
summed in another grouping, which can round differently).

Why the backward range nests. The result's nodes are the last that
``fn`` creates, and a bracketed tensor's node (or the identity) was
created before ``fn`` ran, so the sequence numbers of ``fn``'s nodes lie
between the two; the engine runs the ready nodes of a device by falling
sequence number. When the first of the result's nodes runs it is the
highest ready node, so no node numbered above it runs later; until
every node of ``fn`` that the backward reaches has run, the highest of
them is ready and runs before any node numbered below ``fn``'s. So the
range holds the backward of ``fn`` and nothing outside it (given that
the bracketed tensors have no other use), and brackets nested in ``fn``
(or around it) give nested ranges.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def active() -> bool:
    """Whether a profiler records ranges now (one flag check)."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A context that opens the range ``name`` on the calling thread
    while a profiler is active, and does nothing otherwise."""
    return record_function(name) if active() else _OFF


class _Backward:
    """One range around a backward: opened once, closed once."""

    __slots__ = ("record", "state")

    def __init__(self, name: str):
        self.record = record_function(name)
        self.state = 0                      # 0 not yet open, 1 open, 2 shut

    def open(self, _grads) -> None:
        if self.state == 0:
            self.record.__enter__()
            self.state = 1

    def close(self, _grad=None) -> None:
        if self.state == 1:
            self.record.__exit__(None, None, None)
            self.state = 2


class _Close(torch.autograd.Function):
    """Identity over bracketed leaves; its backward closes the range."""

    @staticmethod
    def forward(ctx, rng, *xs):
        ctx.rng = rng
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.rng.close()
        return (None, *grads)


def bracket(name: str, fn: Callable, *tensors):
    """``fn(*tensors)`` with the range ``name`` around its backward
    while a profiler is active (see the module docstring). ``fn``
    returns a tensor or a tuple; the range opens at the nodes of the
    tensors at the tuple's top level."""
    if not (active() and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        return fn(*tensors)
    rng = _Backward(name)
    made = [t for t in tensors if t.grad_fn is not None]
    out = fn(*(tensors if made else _Close.apply(rng, *tensors)))
    ys = [out] if isinstance(out, torch.Tensor) else list(out)
    for node in {y.grad_fn for y in ys if isinstance(y, torch.Tensor)
                 and y.grad_fn is not None}:
        node.register_prehook(rng.open)
    for t in made:
        t.register_hook(rng.close)
    return out
