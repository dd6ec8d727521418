"""Bucketed data-parallel gradient synchronization, optionally overlapped
with the backward pass and optionally int8-compressed.

Port of ``src/repro/parallel/grad_sync.py``. The reference flattens the
gradient tree into equal-sized fp32 buckets and mean-reduces each over
the dp mesh axes inside ``shard_map``; its ``mode="int8"`` quantizes
each bucket with error feedback (``compress.compressed_psum``), so an
int8 cell's numbers differ from an fp32 cell's on one device too. In the
port the buckets are rows of one ``(n_buckets, bucket_elems)`` tensor,
flattened in the reference's leaf order (``jax.tree.flatten``'s sorted
dict keys, so the bucket boundaries and with them the int8 scales are
the reference's), and each row is all-reduced over the plan's dp process
group (``launch.mesh``; a world of one reduces nothing). With
``overlap`` each microbatch's rows are issued as
``all_reduce(async_op=True)`` as soon as its backward is done and waited
on after the next microbatch's backward, before they are accumulated;
the reference's rule keeps overlap off on the CPU (``default_sync``).

The step keeps the reference's signature ``(params, opt_state,
sync_state, batch) -> (params, opt_state, sync_state, metrics)``; it
takes the global batch, computes on this rank's rows of it
(``sharding.local_batch``), reports loss, CE and aux as means over the
ranks, and updates the ZeRO-1 slices of the optimizer state it is given
(``sharding.Zero1``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree
from repro_torch.core.ranges import span
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import dp_mean, group_size, pmean
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.compress import compressed_psum
from repro_torch.train.optimizer import OptConfig, opt_update
from repro_torch.train.step import (StepConfig, _split_mb, make_loss_fn,
                                    scan_microbatch_grads, value_and_grad)

Params = Any

#: accepted values of the llm_train ``grad_sync`` Space axis
GRAD_SYNC_MODES = ("fp32", "int8")


@dataclass(frozen=True)
class GradSyncConfig:
    """How the dp gradient all-reduce is performed."""

    mode: str = "fp32"        # "fp32" | "int8" (compressed + error feedback)
    bucket_mb: float = 4.0    # bucket size cap, MiB of fp32
    overlap: bool = True      # sync each microbatch's grads as they come

    def __post_init__(self):
        if self.mode not in GRAD_SYNC_MODES:
            raise ValueError(f"grad_sync mode {self.mode!r} not in "
                             f"{GRAD_SYNC_MODES}")

    @property
    def bucket_elems(self) -> int:
        return max(1, int(self.bucket_mb * (1 << 20) / 4))


def default_sync(mode: str = "fp32",
                 device: DeviceLike = None) -> GradSyncConfig:
    """The reference turns overlap on for every backend but the CPU,
    where the per-microbatch sync is pure overhead; so does the port:
    on for the card, off on the CPU."""
    return GradSyncConfig(mode=mode,
                          overlap=resolve_device(device).type != "cpu")


# ---------------------------------------------------------------------------
# Bucketing
# ---------------------------------------------------------------------------


def flatten_buckets(grads, bucket_elems: int):
    """Flatten a tree into equal-size fp32 buckets, the rows of one
    ``(n_buckets, bucket_elems)`` tensor (the last one zero-padded).
    Returns ``(buckets, meta)``; ``meta`` round-trips through
    :func:`unflatten_buckets`."""
    leaves = tree.leaves(grads)
    sizes = [l.numel() for l in leaves]
    n = sum(sizes)
    nb = max(1, math.ceil(n / bucket_elems))
    flat = torch.empty(nb * bucket_elems, dtype=torch.float32,
                       device=leaves[0].device)
    off = 0
    for l, size in zip(leaves, sizes):
        flat[off:off + size].copy_(l.reshape(-1))
        off += size
    flat[n:].zero_()
    meta = (tree.tree_map(lambda _: None, grads), sizes,
            [l.shape for l in leaves],
            [l.dtype for l in leaves], n)
    return flat.view(nb, bucket_elems), meta


def unflatten_buckets(buckets: torch.Tensor, meta):
    template, sizes, shapes, dtypes, n = meta
    flat = buckets.reshape(-1)[:n]
    out, off = [], 0
    for size, shape, dt in zip(sizes, shapes, dtypes):
        out.append(flat[off:off + size].view(shape).to(dt))
        off += size
    return tree.unflatten(template, out)


def n_buckets(params, bucket_elems: int) -> int:
    total = sum(l.numel() for l in tree.leaves(params))
    return max(1, math.ceil(total / bucket_elems))


# ---------------------------------------------------------------------------
# Reduction over the dp group
# ---------------------------------------------------------------------------


def reduce_buckets(buckets: torch.Tensor, mode: str, errors=None,
                   group=None):
    """Mean-reduce each bucket (row) over ``group``. Returns
    ``(reduced, new_errors)`` — errors only meaningful for int8."""
    if mode == "int8":
        return compressed_psum(buckets, errors, group)
    if group is not None:
        for row in buckets:
            dist.all_reduce(row, group=group)
        buckets = buckets / group_size(group)
    return buckets, errors


def sync_grads(grads, sync: GradSyncConfig, errors=None, group=None):
    """Tree-level bucketed gradient mean over ``group``. Returns
    ``(synced_grads, new_errors)``."""
    with span("grad_sync"):
        buckets, meta = flatten_buckets(grads, sync.bucket_elems)
        red, new_e = reduce_buckets(buckets, sync.mode, errors, group)
        return unflatten_buckets(red, meta), new_e


def naive_psum_sync(grads, group=None):
    """Reference: per-leaf fp32 all-reduce mean (what GSPMD would insert)
    — the numeric-equivalence target for the bucketed path in tests."""
    return dp_mean(grads, [], group)[0]


# ---------------------------------------------------------------------------
# The dp train step
# ---------------------------------------------------------------------------


def init_sync_state(params: Params, sync: GradSyncConfig) -> torch.Tensor:
    """This rank's sync state, ``(1, n_buckets, bucket_elems)``: the int8
    error-feedback residual per bucket, or an empty ``(1, 1, 0)``
    placeholder in fp32 mode (the reference keeps one step signature
    across modes; its state is the ranks' rows, dp-sharded)."""
    dev = tree.leaves(params)[0].device
    if sync.mode == "int8":
        nb = n_buckets(params, sync.bucket_elems)
        return torch.zeros((1, nb, sync.bucket_elems), dtype=torch.float32,
                           device=dev)
    return torch.zeros((1, 1, 0), dtype=torch.float32, device=dev)


def _overlapped_grads(vg, params, batch: dict, k: int, gdt,
                      sync: GradSyncConfig, group, errs):
    """Gradient accumulation over ``k`` microbatches whose buckets are
    reduced while the next microbatch's backward runs: fp32 rows are
    issued asynchronously and waited on one microbatch later; int8 rows
    (the shared scale must be known before the codes) synchronously.
    Returns ``(grads, errs, loss, ce, aux)``, sums over the k steps."""
    mbs = {key: _split_mb(x, k) for key, x in batch.items()}
    g_acc = tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=gdt, device=p.device), params)
    n = group_size(group)
    pending = None

    def land(buckets, meta, handles):
        with span("grad_sync"):
            for h in handles:
                h.wait()
            if handles:
                buckets = buckets / n
            g = unflatten_buckets(buckets, meta)
        for a, x in zip(tree.leaves(g_acc), tree.leaves(g), strict=True):
            a.add_(x.to(gdt))

    dev = tree.leaves(params)[0].device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    ce = torch.zeros((), dtype=torch.float32, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(k):
        (l_i, (ce_i, aux_i)), g = vg(params, {key: x[i]
                                              for key, x in mbs.items()})
        if pending is not None:
            land(*pending)
        with span("grad_sync"):
            buckets, meta = flatten_buckets(g, sync.bucket_elems)
            del g
            if sync.mode == "int8" or group is None:
                buckets, errs = reduce_buckets(buckets, sync.mode, errs,
                                               group)
                pending = (buckets, meta, [])
            else:
                pending = (buckets, meta,
                           [dist.all_reduce(row, group=group, async_op=True)
                            for row in buckets])
        loss, ce, aux = loss + l_i, ce + ce_i, aux + aux_i
    land(*pending)
    return g_acc, errs, loss, ce, aux


def make_dp_train_step(c: ModelConfig, oc: OptConfig,
                       sc: StepConfig = StepConfig(), *,
                       plan: Optional[shd.Plan] = None,
                       sync: GradSyncConfig = GradSyncConfig(),
                       zero: Optional[shd.Zero1] = None):
    """Data-parallel train step with explicit bucketed gradient sync:
    ``train_step(params, opt_state, sync_state, batch) -> (params,
    opt_state, sync_state, metrics)``.

    ``plan`` (default: a world of one) names the dp group and splits the
    global batch; each rank's ``sc.microbatches`` split its own rows.
    ``zero`` is the ZeRO-1 layout of ``opt_state`` (default: the state
    is whole). With ``overlap`` and more than one microbatch each
    microbatch's gradients are synced as they come; otherwise the
    accumulated ones are. Loss, CE and aux are the means over ranks of
    each rank's token means, as the reference's ``shard_map`` step
    computes them."""
    vg = value_and_grad(make_loss_fn(c, sc))
    k = max(sc.microbatches, 1)
    gdt = getattr(torch, sc.grad_dtype)
    group = None
    if plan is not None:
        group = plan.mesh.group(plan.dp)

    def train_step(params, opt_state, sync_state, batch):
        if plan is not None:
            batch = shd.local_batch(plan, batch)
        errs = sync_state[0] if sync.mode == "int8" else None
        if sync.overlap and k > 1:
            grads, errs, loss, ce, aux = _overlapped_grads(
                vg, params, batch, k, gdt, sync, group, errs)
        else:
            if k > 1:
                grads, _, loss, ce, aux = scan_microbatch_grads(
                    vg, params, batch, k, gdt)
            else:
                (loss, (ce, aux)), grads = vg(params, batch)
                grads = tree.tree_map(lambda g: g.to(gdt), grads)
            grads, errs = sync_grads(grads, sync, errs, group)
        grads = tree.tree_map(lambda g: (g / k).float(), grads)
        loss, ce, aux = pmean([loss / k, ce / k, aux / k], group)
        new_sync = errs[None] if sync.mode == "int8" else sync_state
        new_p, new_o, info = opt_update(oc, grads, opt_state, params, zero)
        metrics = {"loss": loss, "ce": ce, "aux": aux, **info}
        return new_p, new_o, new_sync, metrics

    return train_step
