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

**Megatron sequence parallelism** (the plan's ``seq_parallel``, the
reference's ``resid_spec``): ``blocks.stack_forward`` installs a copy of
the layout with ``seq_axis="model"`` when the plan asks for it and tp
divides the sequence (:func:`sequence_parallel`); the decoder slots then
keep the residual stream cut on the sequence, each tp rank holding
``S / tp`` rows, and the norms run on those rows. The model code's
brackets change meaning with it:

  * :meth:`Layout.enter` (Megatron's ``f``, all-reduce backward) becomes
    an all-gather of the sequence whose backward reduce-scatters the
    split compute's partial gradients; a replicated consumer of the
    gathered rows in the same sublayer (the router, K/V computed whole)
    takes a view whose whole gradient counts once, on tp rank 0
    (:func:`once`), so that the reduce-scatter sums it once;
  * :meth:`Layout.exit` (``g``, an all-reduce) becomes a reduce-scatter
    of the sequence whose backward all-gathers;
  * compute every tp rank does whole (the mamba mixer, a sublayer the
    plan leaves unsplit) gathers its input with :meth:`Layout.whole_in`
    and takes the rank's rows of its output with :meth:`Layout.whole_out`,
    whose backward all-gathers: every rank then back-propagates the
    whole gradient through it, as without sequence parallelism, so its
    weights' gradients are whole on every tp rank (a zero gradient outside
    the rank's rows would leave each rank's gradient of those weights
    covering its own rows only);
  * a replicated leaf applied to the rank's rows (the norms, a bias added
    after the reduce-scatter) passes :meth:`Layout.on_rows`, Megatron's
    all-reduce of those leaves' gradients.

Every replicated leaf's gradient is thus whole on every tp rank, what
``sharding.Zero1.reduce_grad`` takes it to be.

**The MoE dispatch buffer's D over ``model``** (``moe_dshard``, with
expert parallelism; the reference's ``buf_spec``): ``models.moe`` cuts
the tokens' D with :meth:`Layout.cut` and moves the buffer's rows to
their experts' ranks and back with :meth:`Layout.all_to_all`.

Megatron's ``f`` and ``g`` (:func:`copy_to_tp`, :func:`reduce_from_tp`),
:func:`gather_storage`, :func:`scatter` and :func:`all_to_all` are
autograd functions over the collectives of whatever mesh the layout
holds (``launch.mesh.Mesh`` on ranks, the dry run's ``CountingMesh`` on
``meta``), so the model code depends on this module and nothing of the
launcher.
"""
from __future__ import annotations

import contextlib
import dataclasses
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


class _Scatter(torch.autograd.Function):
    """The transpose of :class:`_GatherStorage`: forward reduce-scatter
    of ``dim`` (``summed``) or the rank's chunk of it, backward
    all-gather."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, summed):
        ctx.args = (mesh, axis, dim)
        if summed:
            return mesh.reduce_scatter(x, axis, dim)
        rows = x.shape[dim] // mesh.axes_size(axis)
        return x.narrow(dim, mesh.index(axis) * rows, rows).clone()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return mesh.all_gather(g, axis, dim), None, None, None, None


class _AllToAll(torch.autograd.Function):
    """Forward all-to-all (``split`` dim cut, ``concat`` dim joined),
    backward the all-to-all that undoes it."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.args = (mesh, axis, split, concat)
        return mesh.all_to_all(x, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split, concat = ctx.args
        return mesh.all_to_all(g, axis, concat, split), None, None, None, None


class _Once(torch.autograd.Function):
    """Forward identity; backward the gradient on the ranks that
    ``keep`` it, zeros on the others."""

    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


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


def scatter(x: torch.Tensor, mesh, axis: str, dim: int,
            summed: bool) -> torch.Tensor:
    """Reduce-scatter (``summed``) or cut ``x``'s ``dim`` over ``axis``,
    the rank's chunk; the gradient goes back by all-gather."""
    if mesh.axes_size(axis) == 1:
        return x
    return _Scatter.apply(x, mesh, axis, dim, summed)


def all_to_all(x: torch.Tensor, mesh, axis: str, split: int,
               concat: int) -> torch.Tensor:
    """``mesh.all_to_all`` over ``axis`` with its transpose as the
    backward."""
    if mesh.axes_size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split, concat)


def once(x: torch.Tensor, keep: bool) -> torch.Tensor:
    """``x``, its gradient kept where ``keep`` and zero elsewhere: a
    gradient that is whole on every rank, entering a sum over them,
    counted once."""
    return _Once.apply(x, keep)


@dataclass(frozen=True)
class Layout:
    """One rank's layout: its mesh (a ``launch.mesh.Mesh`` or the dry
    run's ``CountingMesh``), the tensor-parallel degree in use (1 when the plan
    does not use the ``model`` axis for tensor parallelism), the storage
    cuts of every leaf by path (``(dim, axis, summed)`` on the stored,
    layer-stacked leaf), the axes cutting the batch rows, in a
    long-context decode the axis cutting the caches' sequence, and the
    plan's sequence parallelism and MoE buffer cut."""

    mesh: Any
    tp: int
    storage: dict
    batch_axes: tuple = ()
    #: the axis cutting dense caches' sequence (a long-context decode)
    cache_seq_axis: Optional[str] = None
    #: the plan asks for Megatron sequence parallelism (the training
    #: stack turns it on, :func:`sequence_parallel`)
    seq_parallel: bool = False
    #: the axis cutting the residual stream's sequence where it is on
    seq_axis: Optional[str] = None
    #: the MoE dispatch buffer's D over ``model`` (expert parallelism)
    moe_dshard: bool = False

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

    # -- the split compute's brackets, with or without the sequence cut ----

    def enter(self, x: torch.Tensor) -> tuple:
        """``(xc, xw)``: the residual-derived input ``x`` (B, S, D) of
        compute split over ``model``, for the split compute (``xc``) and
        for compute done whole in the same sublayer (``xw``). Without
        the sequence cut ``(col(x), x)``; with it ``x`` holds the rank's
        rows: both are the all-gathered rows, whose backward
        reduce-scatters, ``xw`` counting its whole gradient once."""
        if self.seq_axis is None:
            return self.col(x), x
        g = gather_storage(x, self.mesh, self.seq_axis, 1, summed=True)
        return g, once(g, self.tp_rank == 0)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """The split compute's partial sums (B, S, D) made whole: an
        all-reduce, or with the sequence cut a reduce-scatter to the
        rank's rows whose backward all-gathers."""
        if self.seq_axis is None:
            return self.row(y)
        return scatter(y, self.mesh, self.seq_axis, 1, summed=True)

    def whole_in(self, x: torch.Tensor) -> torch.Tensor:
        """Every row of ``x`` (B, S, D) for compute every tp rank does
        whole: with the sequence cut an all-gather whose backward takes
        the rank's rows of the (whole) gradient."""
        return x if self.seq_axis is None else self.gather_whole(x, 1)

    def whole_out(self, y: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a whole output (B, S, D): with the sequence
        cut a cut whose backward all-gathers."""
        return y if self.seq_axis is None else self.cut(y, 1)

    def on_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A replicated leaf applied to the rank's rows: with the sequence
        cut its gradient is summed over ``model`` (:meth:`col`)."""
        return t if self.seq_axis is None else self.col(t)

    def cut(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This tp rank's chunk of ``t``'s whole ``dim``, the gradient
        all-gathered (every tp rank computes on its chunk)."""
        return scatter(t, self.mesh, "model", dim, summed=False) \
            if self.tp > 1 else t

    def gather_whole(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every tp rank's chunk of ``dim``, concatenated; the ranks go on
        alike, so the gradient's backward takes the rank's chunk."""
        return gather_storage(t, self.mesh, "model", dim, summed=False) \
            if self.tp > 1 else t

    def all_to_all(self, t: torch.Tensor, split: int,
                   concat: int) -> torch.Tensor:
        """All-to-all over ``model``: ``split`` cut, ``concat`` joined."""
        return all_to_all(t, self.mesh, "model", split, concat) \
            if self.tp > 1 else t

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


@contextlib.contextmanager
def sequence_parallel(seq_len: int):
    """Megatron sequence parallelism inside the block: when the current
    layout's plan asks for it and tp divides ``seq_len`` (the
    reference's ``sp_ax``), install a copy of it whose ``seq_axis`` is
    ``model`` and yield that copy; else change nothing and yield None
    (plain tensor parallelism, as the reference runs it)."""
    lay = current()
    if lay is None or not lay.seq_parallel or lay.tp == 1 or \
            seq_len % lay.tp:
        yield None
        return
    with use(dataclasses.replace(lay, seq_axis="model")) as sp:
        yield sp


def whole_in(x: torch.Tensor) -> torch.Tensor:
    """:meth:`Layout.whole_in` under the current layout."""
    lay = current()
    return x if lay is None else lay.whole_in(x)


def whole_out(y: torch.Tensor) -> torch.Tensor:
    """:meth:`Layout.whole_out` under the current layout."""
    lay = current()
    return y if lay is None else lay.whole_out(y)


def gather(tree: Any, prefix: tuple, unstacked: bool = False):
    """:meth:`Layout.gather` under the current layout (identity without)."""
    lay = current()
    return tree if lay is None else lay.gather(tree, prefix, unstacked)
