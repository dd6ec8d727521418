"""Bucketed data-parallel gradient synchronization, optionally overlapped
with the backward pass and optionally int8-compressed: the one-device
part.

Port of ``src/repro/parallel/grad_sync.py``. The reference flattens the
gradient tree into equal-sized fp32 buckets and mean-reduces each over
the dp mesh axes inside ``shard_map``; its pure-dp train step runs this
even at dp1, and its ``mode="int8"`` quantizes each bucket with error
feedback (``compress.compressed_psum``), so an int8 cell's numbers differ
from an fp32 cell's on one device too. The port does the same arithmetic
on one device: the buckets are rows of one ``(n_buckets, bucket_elems)``
tensor, flattened in the reference's leaf order (``jax.tree.flatten``'s
sorted dict keys, so the bucket boundaries and with them the int8 scales
are the reference's), and the mean over a world of one is the identity.
``torch.distributed`` and placements of more than one device wait for
ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.compress import compressed_psum
from repro_torch.train.optimizer import OptConfig, opt_update
from repro_torch.train.step import (StepConfig, make_loss_fn,
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
# Reduction over a world of one
# ---------------------------------------------------------------------------


def reduce_buckets(buckets: torch.Tensor, mode: str, errors=None):
    """Mean-reduce each bucket over the (one-device) dp world. Returns
    ``(reduced, new_errors)`` — errors only meaningful for int8."""
    if mode == "int8":
        return compressed_psum(buckets, errors)
    return buckets, errors          # psum / n over one participant


def sync_grads(grads, sync: GradSyncConfig, errors=None):
    """Tree-level bucketed gradient mean. Returns ``(synced_grads,
    new_errors)``."""
    with record_function("grad_sync"):
        buckets, meta = flatten_buckets(grads, sync.bucket_elems)
        red, new_e = reduce_buckets(buckets, sync.mode, errors)
        return unflatten_buckets(red, meta), new_e


# ---------------------------------------------------------------------------
# The dp train step
# ---------------------------------------------------------------------------


def init_sync_state(params: Params, sync: GradSyncConfig) -> torch.Tensor:
    """The per-device sync state of a world of one, ``(1, n_buckets,
    bucket_elems)``: the int8 error-feedback residual per bucket, or an
    empty ``(1, 1, 0)`` placeholder in fp32 mode (the reference keeps one
    step signature across modes)."""
    dev = tree.leaves(params)[0].device
    if sync.mode == "int8":
        nb = n_buckets(params, sync.bucket_elems)
        return torch.zeros((1, nb, sync.bucket_elems), dtype=torch.float32,
                           device=dev)
    return torch.zeros((1, 1, 0), dtype=torch.float32, device=dev)


def make_dp_train_step(c: ModelConfig, oc: OptConfig,
                       sc: StepConfig = StepConfig(), *,
                       sync: GradSyncConfig = GradSyncConfig()):
    """Data-parallel train step with explicit bucketed gradient sync, on
    one device: ``train_step(params, opt_state, sync_state, batch) ->
    (params, opt_state, sync_state, metrics)``. With ``overlap`` and
    more than one microbatch each microbatch's gradients are synced
    before they are accumulated; otherwise the accumulated ones are."""
    vg = value_and_grad(make_loss_fn(c, sc))
    k = max(sc.microbatches, 1)
    gdt = getattr(torch, sc.grad_dtype)

    def train_step(params, opt_state, sync_state, batch):
        errs = sync_state[0] if sync.mode == "int8" else None
        if sync.overlap and k > 1:
            def hook(g, hs):
                return sync_grads(g, sync, hs)

            grads, errs, loss, ce, aux = scan_microbatch_grads(
                vg, params, batch, k, gdt, grad_hook=hook, hook_state=errs)
        else:
            if k > 1:
                grads, _, loss, ce, aux = scan_microbatch_grads(
                    vg, params, batch, k, gdt)
            else:
                (loss, (ce, aux)), grads = vg(params, batch)
                grads = tree.tree_map(lambda g: g.to(gdt), grads)
            grads, errs = sync_grads(grads, sync, errs)
        grads = tree.tree_map(lambda g: (g / k).float(), grads)
        loss, ce, aux = loss / k, ce / k, aux / k   # pmean over one device
        new_sync = errs[None] if sync.mode == "int8" else sync_state
        new_p, new_o, info = opt_update(oc, grads, opt_state, params)
        metrics = {"loss": loss, "ce": ce, "aux": aux, **info}
        return new_p, new_o, new_sync, metrics

    return train_step
