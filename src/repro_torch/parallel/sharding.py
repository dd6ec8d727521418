"""Table-driven sharding rules (DP / TP / FSDP / EP / sequence) and the
ZeRO-1 optimizer-state slices that ranks execute.

Port of ``src/repro/parallel/sharding.py``. The rule table is data and
is ported whole: ``make_plan``'s flags, ``_spec``'s divisible-or-
replicate choice, ``_param_rule`` for every leaf of every family,
``zero1_spec``, ``batch_spec`` and the dp plans. A spec is a tuple with
one entry per dimension, an axis name, a tuple of axis names or
``None``: the content of the reference's ``PartitionSpec`` (``P()`` is
the empty tuple, as there).

What ranks execute in this port is the data-parallel part, meshes whose
``model`` axis is 1 (:func:`check_executable`): params are replicated,
the batch is split over the dp axes (:func:`local_batch`,
``batch_sharding``'s rule), and AdamW's ``m`` / ``v`` / ``master`` are
ZeRO-1 slices (:class:`Zero1`): each rank keeps the slice that
``zero1_spec`` names, updates its slice of each parameter from the
synced full gradient, and ``all_gather``s the slices (gloo has no
``reduce_scatter`` for CUDA tensors). AdamW is elementwise, so the
result equals the replicated update to the bit. Adafactor's factored
states and the scalars replicate, as ``train_state_shardings`` says.
Tensor parallelism, FSDP and expert parallelism as executed layouts,
``cache_sharding``, ``make_attn_hints`` and ``logits_sharding`` are
ROADMAP Queue 1 item 8.
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

#: the error of a layout this port does not execute
NOT_EXECUTED = ("tensor parallelism, FSDP and expert parallelism across "
                "ranks are ROADMAP Queue 1 item 8")


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
# Execution on ranks
# ---------------------------------------------------------------------------


def check_executable(plan: Plan) -> None:
    """Ranks execute data-parallel meshes only: a ``model`` axis above 1
    or an FSDP plan raises."""
    if plan.tp_size > 1 or plan.fsdp:
        raise NotImplementedError(
            f"plan over mesh {dict(plan.mesh.shape)} (tp={plan.tp_size}, "
            f"fsdp={plan.fsdp}): {NOT_EXECUTED}")


class Zero1:
    """The ZeRO-1 slices of one param tree on one rank.

    For each leaf (in the reference's order) the dims that ``zero1_spec``
    cuts over axes of more than one rank. :meth:`local` views a full
    tensor's slice, :meth:`slice_tree` copies a tree's slices,
    :meth:`gather` writes the full tensor from every rank's slice."""

    def __init__(self, plan: Plan, params: Params,
                 c: Optional[ModelConfig] = None):
        check_executable(plan)
        self.mesh = plan.mesh
        psp = _spec_leaves(param_specs(c, plan, params), params)
        self.cuts = []
        for sp, leaf in zip(psp, tree.leaves(params), strict=True):
            z = zero1_spec(plan, sp, tuple(leaf.shape))
            self.cuts.append([(d, _axes_of(part)) for d, part in enumerate(z)
                              if part is not None and
                              self.mesh.axes_size(_axes_of(part)) > 1])

    @property
    def sliced(self) -> bool:
        return any(self.cuts)

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s slice of the full tensor ``t`` (a view)."""
        for d, axes in self.cuts[i]:
            n = self.mesh.axes_size(axes)
            rows = t.shape[d] // n
            t = t.narrow(d, self.mesh.index(axes) * rows, rows)
        return t

    def slice_tree(self, full: Params) -> Params:
        return tree.unflatten(full, [
            self.local(i, t).clone()
            for i, t in enumerate(tree.leaves(full))])

    def gather(self, i: int, part: torch.Tensor) -> torch.Tensor:
        """The full tensor of leaf ``i`` from every rank's ``part``."""
        for d, axes in reversed(self.cuts[i]):
            group = self.mesh.group(axes)
            n = self.mesh.axes_size(axes)
            bufs = [torch.empty_like(part) for _ in range(n)]
            dist.all_gather(bufs, part.contiguous(), group=group)
            part = torch.cat(bufs, dim=d)
        return part

    def gather_tree(self, local: Params) -> Params:
        return tree.unflatten(local, [
            self.gather(i, t) if self.cuts[i] else t
            for i, t in enumerate(tree.leaves(local))])


def shard_opt_state(zero: Zero1, opt_state: Params) -> Params:
    """This rank's copy of ``opt_state``: AdamW's ``m`` / ``v`` /
    ``master`` cut to its ZeRO-1 slices, the other (replicated) states
    whole."""
    return {k: (zero.slice_tree(v) if k in ("m", "v", "master")
                else tree.tree_map(torch.Tensor.clone, v))
            for k, v in opt_state.items()}


def gather_opt_state(zero: Zero1, opt_state: Params) -> Params:
    """The whole-leaf optimizer state from every rank's slices (the
    reference's checkpoint layout); collective."""
    return {k: (zero.gather_tree(v) if k in ("m", "v", "master") else v)
            for k, v in opt_state.items()}


def shard_train_state(plan: Plan, params: Params, opt_state: Params,
                      c: Optional[ModelConfig] = None):
    """This rank's part of a whole ``(params, opt_state)``: params as
    they are (replicated), AdamW's states cut to the ZeRO-1 slices of
    ``train_state_specs``. Returns ``(params, opt_state, zero)``; the
    train steps take ``zero`` to update the slices."""
    zero = Zero1(plan, params, c)
    return params, shard_opt_state(zero, opt_state), zero


@dataclass(frozen=True)
class DpCheckpoint:
    """How a dp world checkpoints a ``(params, opt_state)`` train state:
    every rank gathers the whole leaves (:meth:`whole`, collective), rank
    0 alone writes them, and a restore cuts the whole leaves into each
    rank's slices again (:meth:`local`), for whatever dp size restores."""

    zero: Zero1

    @property
    def writer(self) -> bool:
        return self.zero.mesh.rank == 0

    def whole(self, state):
        params, opt_state = state
        return params, gather_opt_state(self.zero, opt_state)

    def local(self, state):
        params, opt_state = state
        return params, shard_opt_state(self.zero, opt_state)

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()
