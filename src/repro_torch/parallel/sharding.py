"""Table-driven sharding rules (DP / TP / FSDP / EP / sequence) and the
ZeRO-1 optimizer-state slices that ranks execute.

Port of ``src/repro/parallel/sharding.py``. The rule table is data and
is ported whole: ``make_plan``'s flags, ``_spec``'s divisible-or-
replicate choice, ``_param_rule`` for every leaf of every family,
``zero1_spec``, ``batch_spec`` and the dp plans. A spec is a tuple with
one entry per dimension, an axis name, a tuple of axis names or
``None``: the content of the reference's ``PartitionSpec`` (``P()`` is
the empty tuple, as there).

Ranks execute every layout of the table (:class:`Zero1` holds one rank's
part of one param tree): each rank stores its shard of every leaf, as
the leaf's spec cuts it over the mesh coordinates (:func:`leaf_cuts`),
and the model code (``parallel.layout``) computes on it. A dim over
``model`` of the heads of ``wo``, the FFN columns, the experts or the
vocabulary is **compute-sharded**: the rank computes its part and
Megatron's partial-sum collective follows. Every FSDP ``data`` dim, the
``Dh`` cut of ``wq`` / ``wk`` / ``wv`` (the reference's head-TP rule
indexes their unstacked ``(D, H, Dh)`` shape, so it cuts ``Dh``; the
rank gathers it and computes its heads) and of FSDP archs' ``wo``, and
``pos`` tables, are **storage-sharded**: all-gathered just before use,
the gradient going back by reduce-scatter. A leaf the spec replicates
over ``model`` is computed whole on every tp rank. AdamW's ``m`` /
``v`` / ``master`` and the gradient accumulator (ZeRO-2) are further cut
over every axis the param leaves free (``zero1_spec``, the ``model``
axis included); Adafactor's factored states follow the shards. The
batch is split over the dp axes (:func:`local_batch`).
``cache_spec``, ``attn_hints`` and ``logits_spec`` are ported as data.
The plan's ``seq_parallel`` (Megatron sequence parallelism, the
reference's ``resid_spec``) and ``moe_dshard`` (the MoE dispatch
buffer's D over ``model``, its ``buf_spec``) change no param or
optimizer layout: :meth:`Zero1.layout` hands them to the model code
(``parallel.layout``), which executes them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import tree
from repro_torch.launch.mesh import axis_size, dp_axes

Params = Any
Spec = tuple

# FSDP threshold (the reference's): params whose bf16 bytes / TP shard
# would crowd a 16 GiB chip once grads + ZeRO-1 states are added.
FSDP_PARAM_THRESHOLD = 32e9

@dataclass(frozen=True)
class Plan:
    """Resolved parallel layout for one (arch, mesh, shape) cell."""

    mesh: Any
    dp: tuple[str, ...]          # batch axes
    tp: str                      # tensor-parallel axis name
    tp_size: int
    fsdp: bool                   # shard weights over "data" as well
    tp_heads: bool               # Megatron head-TP possible
    ep: bool                     # experts sharded over tp axis
    seq_axis: Optional[str]      # shard cache sequence dim (long-context)
    attn_impl: str               # "repeat" | "grouped"
    use_tp: bool = True          # False: model axis becomes extra DP
    seq_parallel: bool = False   # Megatron SP: shard resid seq over tp
    moe_dshard: bool = False     # constrain MoE dispatch buffer d over tp

    @property
    def fsdp_axis(self) -> Optional[str]:
        return "data" if self.fsdp else None


def make_plan(c: ModelConfig, mesh, shape: ShapeConfig,
              *, force_fsdp: Optional[bool] = None) -> Plan:
    tp = "model"
    tp_size = axis_size(mesh, tp)
    dp = dp_axes(mesh)
    tp_heads = c.n_heads > 0 and c.n_heads % tp_size == 0
    fsdp = (c.param_count() > FSDP_PARAM_THRESHOLD
            if force_fsdp is None else force_fsdp)
    ep = c.n_experts > 0 and c.n_experts % tp_size == 0
    seq_axis = "data" if (shape.kind == "decode" and shape.global_batch
                          < axis_size(mesh, "data")) else None
    return Plan(mesh=mesh, dp=dp, tp=tp, tp_size=tp_size, fsdp=fsdp,
                tp_heads=tp_heads, ep=ep, seq_axis=seq_axis,
                attn_impl="repeat" if tp_heads else "grouped")


def make_dp_plan(mesh) -> Plan:
    """Pure data-parallel Plan for models the table-driven LM rules do
    not describe (ResNet): params replicate, batch shards over every
    non-"model" axis, optimizer state still ZeRO-1-shards over whatever
    axes divide it."""
    return Plan(mesh=mesh, dp=dp_axes(mesh), tp="model",
                tp_size=axis_size(mesh, "model"), fsdp=False,
                tp_heads=False, ep=False, seq_axis=None,
                attn_impl="repeat", use_tp=False)


def dp_size(plan: Plan) -> int:
    """Total data-parallel degree of a plan (product of its dp axes)."""
    return math.prod(axis_size(plan.mesh, a) for a in plan.dp)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def _spec(plan: Plan, shape: tuple, wants: list, stacked: bool) -> Spec:
    """A spec from (dim, axis) requests; a non-divisible one is skipped.
    ``wants`` dims index the unstacked shape; ``stacked`` shifts them by
    one for the stacked leading layer dim."""
    off = 1 if stacked else 0
    parts: list = [None] * len(shape)
    used: set = set()
    for dim, axis in wants:
        d = dim + off
        if axis == plan.tp and not plan.use_tp:
            axis = None  # dp-only layout: model axis carries batch instead
        if axis is None or axis in used or d >= len(shape):
            continue
        if shape[d] % axis_size(plan.mesh, axis) == 0:
            parts[d] = axis
            used.add(axis)
    return tuple(parts)


def _param_rule(c: ModelConfig, plan: Plan, path: tuple,
                shape: tuple) -> Spec:
    """The reference's rule for the leaf at ``path`` (a tuple of dict
    keys) of ``shape``."""
    names = [str(k) for k in path]
    leaf = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    stacked = "layers" in names  # stacked leading layer dim
    fa = plan.fsdp_axis
    if not plan.use_tp:
        plan = dataclasses.replace(plan, tp_heads=False, ep=False)

    # --- embeddings -----------------------------------------------------
    if parent == "embed" or (parent == "encoder" and leaf == "pos"):
        if leaf in ("tok", "head"):
            return _spec(plan, shape, [(0, plan.tp), (1, fa)], False)
        if leaf == "pos":
            return _spec(plan, shape, [(0, plan.tp)], False)

    # --- attention: head-TP when n_heads divides tp, else replicated
    # over tp (FSDP over data only) -------------------------------------
    if parent in ("attn", "cross"):
        dh_tp = plan.tp if plan.fsdp else None
        if leaf == "wq":
            if plan.tp_heads:
                return _spec(plan, shape, [(1, fa), (2, plan.tp)], stacked)
            return _spec(plan, shape, [(1, fa), (3, dh_tp)], stacked)
        if leaf in ("wk", "wv"):
            kvh = c.n_kv_heads
            if plan.tp_heads and kvh % plan.tp_size == 0:
                return _spec(plan, shape, [(1, fa), (2, plan.tp)], stacked)
            return _spec(plan, shape, [(1, fa), (3, dh_tp)], stacked)
        if leaf == "wo":
            if plan.tp_heads:
                return _spec(plan, shape, [(0, plan.tp), (2, fa)], stacked)
            return _spec(plan, shape, [(2, fa), (1, dh_tp)], stacked)
        return ()  # biases

    # --- dense mlp / shared expert --------------------------------------
    if parent in ("mlp", "shared"):
        if leaf in ("wi", "wi_gate", "wi_up"):
            return _spec(plan, shape, [(1, plan.tp), (0, fa)], stacked)
        if leaf == "wo":
            return _spec(plan, shape, [(0, plan.tp), (1, fa)], stacked)
        return ()

    # --- moe experts (unstacked (E, D, F) or (E, F, D)) ------------------
    if parent == "experts":
        if plan.ep:
            if leaf in ("wi", "wi_gate", "wi_up"):
                return _spec(plan, shape, [(0, plan.tp), (2, fa)], stacked)
            if leaf == "wo":
                return _spec(plan, shape, [(0, plan.tp), (1, fa)], stacked)
            return _spec(plan, shape, [(0, plan.tp)], stacked)
        if leaf in ("wi", "wi_gate", "wi_up"):
            return _spec(plan, shape, [(2, plan.tp), (1, fa)], stacked)
        if leaf == "wo":
            return _spec(plan, shape, [(1, plan.tp), (2, fa)], stacked)
        return ()
    if leaf == "router":
        return ()

    # --- mamba ------------------------------------------------------------
    if parent == "mamba":
        if leaf in ("in_proj", "out_proj"):
            return _spec(plan, shape, [(0, fa)], stacked)
        return ()

    # --- norms, scalars ----------------------------------------------------
    return ()


def param_specs(c: Optional[ModelConfig], plan: Plan, params: Params):
    """Tree of param specs: the rule table with an LM config, replicated
    (``()``) without one (classic DP)."""
    if c is None:
        return tree.tree_map(lambda _: (), params)
    return tree.unflatten(params, [
        _param_rule(c, plan, path, tuple(leaf.shape))
        for path, leaf in tree.paths(params)])


# ---------------------------------------------------------------------------
# Optimizer-state specs (ZeRO-1 / Megatron distributed optimizer)
# ---------------------------------------------------------------------------


def zero1_spec(plan: Plan, spec: Spec, shape: tuple) -> Spec:
    """Extra-shard optimizer state over every mesh axis the parameter
    does not use: for each of "data", "model", "pod" in turn, the
    largest unsharded dimension it divides (the first on a tie)."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    if not shape:
        return tuple(spec)
    used: set = set()
    for part in spec:
        for a in (part if isinstance(part, tuple) else (part,)):
            if a:
                used.add(a)
    for axis in ("data", "model", "pod"):
        if axis in used or axis not in plan.mesh.axis_names:
            continue
        asz = axis_size(plan.mesh, axis)
        candidates = [i for i in range(len(shape))
                      if spec[i] is None and shape[i] % asz == 0]
        if candidates:
            i = max(candidates, key=lambda i: shape[i])
            spec[i] = axis
            used.add(axis)
    return tuple(spec)


def opt_state_specs(plan: Plan, param_specs_tree, params: Params):
    return tree.unflatten(params, [
        zero1_spec(plan, sp, tuple(leaf.shape))
        for sp, leaf in zip(_spec_leaves(param_specs_tree, params),
                            tree.leaves(params), strict=True)])


def _spec_leaves(specs_tree, params: Params) -> list:
    """The specs of ``specs_tree`` in ``params``' leaf order (a spec is a
    tuple, which :func:`tree.leaves` would walk into)."""
    out = []

    def walk(s, p):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(s[k], p[k])
        elif isinstance(p, (list, tuple)):
            for si, pi in zip(s, p):
                walk(si, pi)
        else:
            out.append(s)

    walk(specs_tree, params)
    return out


def train_state_specs(plan: Plan, params: Params, opt_state: Params,
                      c: Optional[ModelConfig] = None):
    """``(param specs, optimizer-state specs)`` for one Plan: AdamW's
    ``m`` / ``v`` / ``master`` mirror the params and get the ZeRO-1
    extra-sharding; scalars and factored Adafactor states replicate."""
    psp = param_specs(c, plan, params)
    mirrored = opt_state_specs(plan, psp, params)
    osp = {k: (mirrored if k in ("m", "v", "master")
               else _replicated_like(v))
           for k, v in opt_state.items()}
    return psp, osp


def _replicated_like(t):
    if isinstance(t, dict):
        return {k: _replicated_like(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_replicated_like(v) for v in t)
    return ()


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------


def batch_spec(plan: Plan, shape: tuple, batch_dim: int = 0) -> Spec:
    parts: list = [None] * len(shape)
    b = shape[batch_dim]
    if b % dp_size(plan) == 0:
        # a PartitionSpec names a one-axis tuple by the axis
        parts[batch_dim] = plan.dp if len(plan.dp) > 1 else plan.dp[0]
    elif b % axis_size(plan.mesh, "data") == 0:
        parts[batch_dim] = "data"
    return tuple(parts)


def _axes_of(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def local_batch(plan: Plan, batch: dict, batch_dim: int = 0) -> dict:
    """This rank's rows of a global batch under :func:`batch_spec`."""
    out = {}
    for k, x in batch.items():
        axes = _axes_of(batch_spec(plan, tuple(x.shape), batch_dim)
                        [batch_dim])
        n = plan.mesh.axes_size(axes) if axes else 1
        if n > 1:
            rows = x.shape[batch_dim] // n
            x = x.narrow(batch_dim, plan.mesh.index(axes) * rows, rows)
        out[k] = x
    return out


# ---------------------------------------------------------------------------
# Cache, attention and logits specs (data: the dry run's inputs, the loss)
# ---------------------------------------------------------------------------


def cache_spec(c: ModelConfig, plan: Plan, path: tuple, shape: tuple) -> Spec:
    """The reference's ``cache_sharding``: a layer-stacked cache leaf's
    spec. attn k/v (L, B, T, Kh, Dh); mamba conv (L, B, K-1, CH), ssm
    (L, B, nh, hp, ns). Batch over dp when divisible (else "data"); a
    long-context decode (batch below the data axis) shards the sequence
    instead; K/V heads over tp when divisible, else the head dim."""
    leaf = str(path[-1])
    parts: list = [None] * len(shape)
    bdim = 1
    if shape[bdim] % dp_size(plan) == 0:
        parts[bdim] = plan.dp if len(plan.dp) > 1 else plan.dp[0]
    elif shape[bdim] % axis_size(plan.mesh, "data") == 0:
        parts[bdim] = "data"
    if leaf in ("k", "v"):
        if parts[bdim] is None and plan.seq_axis and \
                shape[2] % axis_size(plan.mesh, plan.seq_axis) == 0:
            parts[2] = plan.seq_axis
        if shape[3] % plan.tp_size == 0:
            parts[3] = plan.tp
        elif shape[4] % plan.tp_size == 0:
            parts[4] = plan.tp
    elif leaf == "ssm":
        if shape[2] % plan.tp_size == 0:
            parts[2] = plan.tp
    return tuple(parts)


@dataclass(frozen=True)
class AttnHints:
    """The reference's ``AttnShardingHints`` as specs."""

    q_spec: Spec
    kv_spec: Spec
    out_spec: Spec
    cache_spec: Optional[Spec]
    resid_spec: Spec


def attn_hints(c: ModelConfig, plan: Plan, batch: int, cache_seq: int = 0,
               decode: bool = False, seq_len: int = 0) -> AttnHints:
    """The reference's ``make_attn_hints``: q/k/v/out and cache specs of
    one cell (decode keeps the heads whole against a Kh- or Dh-sharded
    cache)."""
    mesh, tp = plan.mesh, plan.tp
    if batch % dp_size(plan) == 0:
        bs = plan.dp if len(plan.dp) > 1 else plan.dp[0]
    elif batch % axis_size(mesh, "data") == 0:
        bs = "data"
    else:
        bs = None
    h_ax = tp if (plan.tp_heads and not decode) else None
    kv_ax = tp if (plan.tp_heads and not decode
                   and c.n_kv_heads % plan.tp_size == 0) else None
    q = (bs, None, h_ax, None)
    cspec = None
    if cache_seq:
        parts = [bs, None, None, None]
        if bs is None and plan.seq_axis and cache_seq % axis_size(
                mesh, plan.seq_axis) == 0:
            parts[1] = plan.seq_axis
        if c.n_kv_heads and c.n_kv_heads % plan.tp_size == 0:
            parts[2] = tp
        elif c.d_head and c.d_head % plan.tp_size == 0:
            parts[3] = tp
        cspec = tuple(parts)
    sp_ax = (plan.tp if (plan.seq_parallel and seq_len
                         and seq_len % plan.tp_size == 0) else None)
    return AttnHints(q_spec=q, kv_spec=(bs, None, kv_ax, None), out_spec=q,
                     cache_spec=cspec, resid_spec=(bs, sp_ax, None))


def logits_spec(plan: Plan, shape: tuple) -> Spec:
    """The reference's ``logits_sharding``: rows over dp, the vocabulary
    over tp when divisible (the vocabulary-parallel loss's input)."""
    parts: list = [None] * len(shape)
    if shape[0] % dp_size(plan) == 0:
        parts[0] = plan.dp if len(plan.dp) > 1 else plan.dp[0]
    elif shape[0] % axis_size(plan.mesh, "data") == 0:
        parts[0] = "data"
    if shape[-1] % plan.tp_size == 0:
        parts[-1] = plan.tp
    return tuple(parts)


def grad_specs(plan: Plan, param_specs_tree, params: Params):
    """ZeRO-2: the gradient accumulator takes the optimizer state's
    ZeRO-1 specs (the reference's ``grad_shardings``), so each rank
    reduce-scatters a microbatch's gradient into its slice."""
    return opt_state_specs(plan, param_specs_tree, params)


# ---------------------------------------------------------------------------
# Execution on ranks
# ---------------------------------------------------------------------------

def _cut_kind(c: ModelConfig, plan: Plan, names: list, dim: int,
              axis: str) -> tuple:
    """``(storage, summed)`` of a sharded dim of the leaf at ``names``.

    Storage-sharded dims are all-gathered before use: every FSDP
    ``data`` dim, ``pos`` tables, and every ``model`` dim of the
    attention's ``wq`` / ``wk`` / ``wv`` and of ``wo`` but its heads.
    The reference's head-TP rule cuts ``wq`` / ``wk`` / ``wv`` on the
    head dim ``Dh`` (its ``(2, tp)`` indexes the unstacked ``(D, H, Dh)``
    leaf) and ``wo`` on the heads: the rank gathers ``Dh`` and computes
    its heads. ``summed``: the ranks of the axis use different parts of
    the gathered leaf (other rows of the batch, or other heads), so the
    gradient goes back by reduce-scatter; otherwise (a replicated
    compute over ``model``) each takes its chunk. The rest over
    ``model`` is compute-sharded: heads of ``wo``, FFN columns, experts,
    vocabulary rows."""
    if axis != plan.tp:
        return True, True
    leaf = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    off = 1 if "layers" in names else 0
    if leaf == "pos":
        return True, False
    if parent in ("attn", "cross"):
        if leaf == "wo" and dim - off == 0:
            return False, False
        heads = plan.tp_heads and (
            leaf == "wq" or (leaf in ("wk", "wv")
                             and c.n_kv_heads % plan.tp_size == 0))
        return True, heads
    return False, False


def leaf_cuts(c: Optional[ModelConfig], plan: Plan, path: tuple,
              shape: tuple) -> list:
    """The dims that ``path``'s leaf (whole ``shape``) is cut on, over
    axes of more than one rank: ``(dim, axis, storage, summed)`` each
    (:func:`_cut_kind`)."""
    if c is None:
        return []
    spec = _param_rule(c, plan, path, shape)
    names = [str(k) for k in path]
    return [(d, part, *_cut_kind(c, plan, names, d, part))
            for d, part in enumerate(spec)
            if part is not None and axis_size(plan.mesh, part) > 1]


def _narrow(t: torch.Tensor, cuts, mesh) -> torch.Tensor:
    for d, axes in cuts:
        n = mesh.axes_size(axes)
        rows = t.shape[d] // n
        t = t.narrow(d, mesh.index(axes) * rows, rows)
    return t


def _gather(t: torch.Tensor, cuts, mesh) -> torch.Tensor:
    for d, axes in reversed(cuts):
        t = mesh.all_gather(t, axes, d)
    return t


def _factored(cuts, ndim: int) -> tuple:
    """A leaf's cuts mapped onto its Adafactor ``vr`` (the last dim
    reduced) and ``vc`` (the second-to-last reduced) states."""
    if ndim < 2:
        return list(cuts), []
    vr = [(d, a) for d, a in cuts if d < ndim - 1]
    vc = [(d if d < ndim - 2 else d - 1, a) for d, a in cuts
          if d != ndim - 2]
    return vr, vc


class Zero1:
    """The layout of one param tree on one rank: each leaf's param cuts
    (:func:`leaf_cuts`: the rank stores that shard of the whole leaf) and
    its ZeRO-1 cuts (``zero1_spec``'s axes that the param spec leaves
    free, cutting the rank's shard further for AdamW's ``m`` / ``v`` /
    ``master`` and, ZeRO-2, the gradient accumulator).

    Built from the whole (or ``meta``) params, in the reference's leaf
    order. :meth:`shard` / :meth:`unshard` move a param tree between
    whole leaves and this rank's shards; :meth:`local` views a shard's
    ZeRO slice and :meth:`gather` rebuilds the shard from every rank's
    slice; :meth:`layout` is the model code's :class:`Layout`."""

    def __init__(self, plan: Plan, params: Params,
                 c: Optional[ModelConfig] = None):
        self.plan = plan
        self.mesh = plan.mesh
        self.paths = [path for path, _ in tree.paths(params)]
        psp = _spec_leaves(param_specs(c, plan, params), params)
        self.param_cuts, self.cuts, self.ndims = [], [], []
        for path, sp, leaf in zip(self.paths, psp, tree.leaves(params),
                                  strict=True):
            shape = tuple(leaf.shape)
            pc = leaf_cuts(c, plan, path, shape)
            self.param_cuts.append(pc)
            self.ndims.append(len(shape))
            z = zero1_spec(plan, sp, shape)
            self.cuts.append([(d, _axes_of(part)) for d, part in enumerate(z)
                              if part is not None and d not in
                              {cut[0] for cut in pc} and
                              self.mesh.axes_size(_axes_of(part)) > 1])

    @property
    def sliced(self) -> bool:
        return any(self.cuts)

    @property
    def sharded(self) -> bool:
        return any(self.param_cuts)

    def _pcuts(self, i: int) -> list:
        return [(d, (a,)) for d, a, *_k in self.param_cuts[i]]

    def layout(self, batch_axes: tuple = (),
               cache_seq_axis: Optional[str] = None):
        """The :class:`parallel.layout.Layout` of this tree's params, with
        the axes cutting the batch, the one cutting dense caches'
        sequence (a long-context decode) and the plan's
        ``seq_parallel`` and ``moe_dshard`` (the latter with expert
        parallelism only, as the reference lowers it)."""
        from repro_torch.parallel.layout import Layout
        tp = self.mesh.axes_size("model") if self.plan.use_tp else 1
        storage = {}
        for path, pc in zip(self.paths, self.param_cuts):
            cuts = [(d, a, summed) for d, a, st, summed in pc if st]
            if cuts:
                storage[tuple(str(k) for k in path)] = cuts
        return Layout(self.mesh, tp, storage, tuple(batch_axes),
                      cache_seq_axis, seq_parallel=self.plan.seq_parallel,
                      moe_dshard=self.plan.moe_dshard and self.plan.ep)

    # -- params --------------------------------------------------------------

    def shard(self, params: Params) -> Params:
        """This rank's shard of every whole leaf (copies; ``params``
        itself when the plan cuts no param)."""
        if not self.sharded:
            return params
        return tree.unflatten(params, [
            _narrow(t, self._pcuts(i), self.mesh).clone() if
            self.param_cuts[i] else t
            for i, t in enumerate(tree.leaves(params))])

    def unshard(self, params: Params) -> Params:
        """The whole leaves from every rank's shards (collective;
        ``params`` itself when the plan cuts no param)."""
        if not self.sharded:
            return params
        return tree.unflatten(params, [
            _gather(t, self._pcuts(i), self.mesh) if self.param_cuts[i]
            else t for i, t in enumerate(tree.leaves(params))])

    # -- ZeRO slices of the shards ------------------------------------------

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s ZeRO slice of its shard ``t`` (a view)."""
        return _narrow(t, self.cuts[i], self.mesh)

    def gather(self, i: int, part: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s shard from every rank's ZeRO slice ``part``."""
        return _gather(part, self.cuts[i], self.mesh)

    def gather_tree(self, local: Params) -> Params:
        return tree.unflatten(local, [
            self.gather(i, t) if self.cuts[i] else t
            for i, t in enumerate(tree.leaves(local))])

    def replicas(self, i: int, zero: bool = True) -> int:
        """Ranks holding the same elements of leaf ``i``'s (ZeRO-sliced,
        with ``zero``) gradient."""
        axes = {a for _d, a, *_k in self.param_cuts[i]}
        if zero:
            axes |= {a for _d, ax in self.cuts[i] for a in ax}
        return self.mesh.size // self.mesh.axes_size(tuple(axes))

    # -- gradients ----------------------------------------------------------

    def reduce_grad(self, i: int, g: torch.Tensor, batch_axes: tuple,
                    zero: bool = True) -> torch.Tensor:
        """Leaf ``i``'s gradient summed over the batch ranks: over the
        axes its storage gather has not summed already, reduce-scattered
        into its ZeRO slice over the batch axes that cut it (ZeRO-2) and
        narrowed over the others (the ``model`` axis, whose ranks hold
        the same gradient); all-reduced over the rest. ``zero=False``
        keeps the rank's whole shard (Adafactor)."""
        done = {a for _d, a, st, summed in self.param_cuts[i]
                if st and summed and a != "model"}
        todo = [a for a in self.mesh.axis_names
                if a in batch_axes and a not in done
                and self.mesh.axes_size(a) > 1]
        for d, axes in (self.cuts[i] if zero else ()):
            (a,) = axes
            if a in todo:
                g = self.mesh.reduce_scatter(g, a, d)
                todo.remove(a)
            else:
                n = self.mesh.axes_size(a)
                rows = g.shape[d] // n
                g = g.narrow(d, self.mesh.index(a) * rows, rows)
        if todo:
            g = self.mesh.all_reduce(g, tuple(todo))
        return g

    def factored_cuts(self, i: int) -> tuple:
        """Leaf ``i``'s param cuts on its Adafactor ``vr`` and ``vc``."""
        return _factored(self._pcuts(i), self.ndims[i])


def shard_opt_state(zero: Zero1, opt_state: Params) -> Params:
    """This rank's copy of a whole ``opt_state``: AdamW's ``m`` / ``v`` /
    ``master`` cut to the rank's shard and then its ZeRO-1 slice,
    Adafactor's ``vr`` / ``vc`` to the rank's shard of the factored
    statistics, the step whole."""
    out = {}
    for k, v in opt_state.items():
        if k in ("m", "v", "master"):
            out[k] = tree.unflatten(v, [
                zero.local(i, _narrow(t, zero._pcuts(i), zero.mesh)).clone()
                for i, t in enumerate(tree.leaves(v))])
        elif k in ("vr", "vc"):
            j = 0 if k == "vr" else 1
            out[k] = tree.unflatten(v, [
                _narrow(t, zero.factored_cuts(i)[j], zero.mesh).clone()
                for i, t in enumerate(tree.leaves(v))])
        else:
            out[k] = tree.tree_map(torch.Tensor.clone, v)
    return out


def gather_opt_state(zero: Zero1, opt_state: Params) -> Params:
    """The whole-leaf optimizer state from every rank's part (the
    reference's checkpoint layout); collective."""
    out = {}
    for k, v in opt_state.items():
        if k in ("m", "v", "master"):
            out[k] = tree.unflatten(v, [
                _gather(zero.gather(i, t), zero._pcuts(i), zero.mesh)
                for i, t in enumerate(tree.leaves(v))])
        elif k in ("vr", "vc"):
            j = 0 if k == "vr" else 1
            out[k] = tree.unflatten(v, [
                _gather(t, zero.factored_cuts(i)[j], zero.mesh)
                for i, t in enumerate(tree.leaves(v))])
        else:
            out[k] = v
    return out


def shard_train_state(plan: Plan, params: Params, opt_state: Params,
                      c: Optional[ModelConfig] = None):
    """This rank's part of a whole ``(params, opt_state)``: the params cut
    to its shards, the optimizer state to its shards' ZeRO-1 slices
    (:func:`shard_opt_state`). Returns ``(params, opt_state, zero)``; the
    train steps take ``zero`` to update the slices."""
    zero = Zero1(plan, params, c)
    return zero.shard(params), shard_opt_state(zero, opt_state), zero


@dataclass(frozen=True)
class DpCheckpoint:
    """How a sharded world checkpoints a ``(params, opt_state)`` train
    state: every rank gathers the whole leaves (:meth:`whole`,
    collective), rank 0 alone writes them (the reference's whole-leaf
    layout), and a restore cuts the whole leaves into each rank's part
    again (:meth:`local`), for whatever plan restores. It is also the
    rank world that a resume agrees in (:meth:`barrier`,
    :meth:`broadcast`): the writer reads the checkpoint directory and
    every rank takes its answer."""

    zero: Zero1

    @property
    def writer(self) -> bool:
        return self.zero.mesh.rank == 0

    def whole(self, state):
        params, opt_state = state
        return self.zero.unshard(params), gather_opt_state(self.zero,
                                                           opt_state)

    def local(self, state):
        params, opt_state = state
        return self.zero.shard(params), shard_opt_state(self.zero, opt_state)

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()

    def broadcast(self, obj):
        """The writer's ``obj`` on every rank (a picklable object)."""
        if not dist.is_initialized():
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]
