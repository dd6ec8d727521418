"""The sharded layout a rank's model code runs under.

The port's counterpart of the reference's ``sharding_hints`` /
``make_attn_hints`` context (``src/repro/models/attention.py:32-84``):
GSPMD reads constraints and partitions the program itself; here the
train step (and the dry run) installs a :class:`Layout` with
:func:`use`, and the model code asks it, where a leaf may be sharded,
what to do:

  * **storage-sharded** dims (every ``data``-axis FSDP dim, the head
    dim ``Dh`` of the attention's weights over ``model``, ``pos`` tables)
    are all-gathered just before the layer uses them
    (:meth:`Layout.gather`, inside the layer's recomputed region, so the
    backward gathers them again), and their gradient goes back by
    reduce-scatter, or by taking the rank's chunk where every rank
    computed the same thing;
  * **compute-sharded** dims (heads, FFN columns, experts, vocabulary
    over ``model``) stay cut: the model code sees the rank's heads,
    F-slice, experts or vocabulary rows in the leaf's shape, brackets the
    split compute with :meth:`Layout.col` (Megatron's ``f``) and
    :meth:`Layout.row` (``g``), and passes replicated tensors that enter
    the split compute (K/V computed whole, a replicated bias) through
    :meth:`Layout.col` so their gradient is summed over the ranks.

Without a layout (one device) every helper is the identity and the model
code runs as before. ``batch_axes`` are the mesh axes that cut this
microbatch's rows: the MoE layers rank tokens and take the
load-balancing means over them, as the reference's one global program
does.

Megatron's ``f`` and ``g`` (:func:`copy_to_tp`, :func:`reduce_from_tp`)
and :func:`gather_storage` are autograd functions over the collectives of
whatever mesh the layout holds (``launch.mesh.Mesh`` on ranks, the dry
run's ``CountingMesh`` on ``meta``), so the model code depends on this
module and nothing of the launcher.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Optional

import torch

_LAYOUT: ContextVar[Optional["Layout"]] = ContextVar("layout", default=None)


# ---------------------------------------------------------------------------
# Megatron's conjugate operators and the storage gather
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Forward identity, backward all-reduce over ``axes``: a replicated
    activation entering compute that is split over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """Forward all-reduce over ``axes``, backward identity: partial sums
    made whole, each rank's gradient its own part's."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherStorage(torch.autograd.Function):
    """Forward all-gather of a storage-sharded dim; backward
    reduce-scatter (``summed``: the ranks of the axis computed on
    different rows, their gradients add up) or the rank's own chunk of
    the gradient (the ranks computed the same thing, each holds the
    whole gradient already)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, summed):
        ctx.args = (mesh, axis, dim, summed)
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, summed = ctx.args
        if summed:
            return mesh.reduce_scatter(g, axis, dim), None, None, None, None
        n = mesh.axes_size(axis)
        rows = g.shape[dim] // n
        return (g.narrow(dim, mesh.index(axis) * rows, rows),
                None, None, None, None)


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's ``f``: identity forward, all-reduce over ``model``
    backward (not ``torch.distributed.nn.functional.all_reduce``, whose
    backward all-reduces an already replicated gradient)."""
    if mesh.axes_size("model") == 1:
        return x
    return _CopyTo.apply(x, mesh, "model")


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's ``g``: all-reduce over ``model`` forward, identity
    backward."""
    return reduce_from(x, mesh, "model")


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """All-reduce (sum) over ``axes`` forward, identity backward (the
    MoE load-balancing sums over the dp ranks use it too)."""
    if mesh.axes_size(axes) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axes)


def gather_storage(x: torch.Tensor, mesh, axis: str, dim: int,
                   summed: bool) -> torch.Tensor:
    """All-gather ``x``'s ``dim`` over ``axis`` just before use; the
    gradient goes back by reduce-scatter (``summed``) or by taking the
    rank's chunk."""
    if mesh.axes_size(axis) == 1:
        return x
    return _GatherStorage.apply(x, mesh, axis, dim, summed)


@dataclass(frozen=True)
class Layout:
    """One rank's layout: its mesh (a ``launch.mesh.Mesh`` or the dry
    run's ``CountingMesh``), the tensor-parallel degree in use (1 when the plan
    does not use the ``model`` axis for tensor parallelism), the storage
    cuts of every leaf by path (``(dim, axis, summed)`` on the stored,
    layer-stacked leaf), the axes cutting the batch rows and, in a
    long-context decode, the axis cutting the caches' sequence."""

    mesh: Any
    tp: int
    storage: dict
    batch_axes: tuple = ()
    #: the axis cutting dense caches' sequence (a long-context decode)
    cache_seq_axis: Optional[str] = None

    @property
    def tp_rank(self) -> int:
        return self.mesh.index("model") if self.tp > 1 else 0

    @property
    def batch_size(self) -> int:
        return self.mesh.axes_size(self.batch_axes) if self.batch_axes else 1

    @property
    def batch_index(self) -> int:
        return self.mesh.index(self.batch_axes) if self.batch_axes else 0

    # -- Megatron's f and g ----------------------------------------------

    def col(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, all-reduce over ``model`` backward."""
        return copy_to_tp(x, self.mesh) if self.tp > 1 else x

    def row(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce over ``model`` forward, identity backward."""
        return reduce_from_tp(x, self.mesh) if self.tp > 1 else x

    def local(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This tp rank's slice of a whole dim (a replicated leaf used by
        split compute; pass it through :meth:`col` first)."""
        if self.tp == 1:
            return t
        n = t.shape[dim] // self.tp
        return t.narrow(dim, self.tp_rank * n, n)

    # -- the batch's ranks -------------------------------------------------

    def batch_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every batch rank's ``t``, stacked on a new dim 0."""
        if self.batch_size == 1:
            return t[None]
        return self.mesh.all_gather(t[None], self.batch_axes, 0)

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the batch ranks, identity backward."""
        if self.batch_size == 1:
            return t
        return reduce_from(t, self.mesh, self.batch_axes)

    # -- storage-sharded leaves ---------------------------------------------

    def gather(self, tree: Any, prefix: tuple, unstacked: bool = False):
        """``tree`` (the params under ``prefix``) with every storage-sharded
        dim all-gathered; ``unstacked``: ``tree`` is one layer's view of
        layer-stacked leaves (their dims shift down by one)."""
        if not self.storage:
            return tree
        if isinstance(tree, dict):
            return {k: self.gather(v, prefix + (k,), unstacked)
                    for k, v in tree.items()}
        for dim, axis, summed in self.storage.get(prefix, ()):
            tree = gather_storage(tree, self.mesh, axis,
                                  dim - 1 if unstacked else dim, summed)
        return tree


def current() -> Optional[Layout]:
    """The layout installed by :func:`use`, or None (one device)."""
    return _LAYOUT.get()


@contextlib.contextmanager
def use(layout: Optional[Layout]):
    """Install ``layout`` for the model code inside the block."""
    tok = _LAYOUT.set(layout)
    try:
        yield layout
    finally:
        _LAYOUT.reset(tok)


def gather(tree: Any, prefix: tuple, unstacked: bool = False):
    """:meth:`Layout.gather` under the current layout (identity without)."""
    lay = current()
    return tree if lay is None else lay.gather(tree, prefix, unstacked)
