"""Gradient compression: int8 quantized all-reduce with error feedback.

Port of ``src/repro/parallel/compress.py``. The reference's
``compressed_psum`` runs inside ``shard_map`` and reduces over a mesh
axis; the port reduces over a ``torch.distributed`` process group (None,
the default, is a world of one, where both reductions are the identity):

  * the shared scale is an ``all_reduce(MAX)`` of each rank's ``amax``;
  * the codes are summed as an int32 ``all_reduce(SUM)``;
  * the mean divides by the group's size;
  * the error feedback stays local.

Its tensor may hold several equal-sized buckets along its leading dims:
each row of the last dim gets its own scale, from one reduction.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.core import tree
from repro_torch.launch.mesh import group_size

Params = Any


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8. Returns (q, scale)."""
    amax = x.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def shared_codes(xf: torch.Tensor, group=None):
    """``(codes, scale)`` of ``xf`` (fp32) under the scale every rank of
    ``group`` shares: the largest ``amax`` of each row over the ranks,
    over 127. ``codes`` are the rounded fp32 values in [-127, 127]."""
    amax = xf.abs().amax(-1, keepdim=True)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127), scale


def compressed_psum(x: torch.Tensor, error: Optional[torch.Tensor] = None,
                    group=None):
    """int8 mean over ``group`` with error feedback. Returns
    ``(mean-reduced x, new_error)``, one scale per row of the last dim.
    Each rank quantizes its local values; the codes are summed in int32
    (no overflow) and rescaled by the shared scale."""
    xf = x.float()
    if error is not None:
        xf = xf + error
    q, scale = shared_codes(xf, group)
    new_error = xf - q * scale          # residual kept locally
    summed = q.to(torch.int32)
    if group is not None:
        dist.all_reduce(summed, group=group)
    out = summed.float() * scale / float(group_size(group))
    return out, new_error


def make_compressed_grad_sync(group=None):
    """Tree-level compressed gradient mean over ``group``: returns
    ``sync(grads, errors) -> (synced_grads, new_errors)``, one scale per
    leaf (the reference's per-leaf form; the train step buckets
    instead)."""
    def sync(grads, errors):
        out_g, out_e = [], []
        for g, e in zip(tree.leaves(grads), tree.leaves(errors),
                        strict=True):
            og, oe = compressed_psum(g.reshape(-1), e.reshape(-1), group)
            out_g.append(og.view(g.shape).to(g.dtype))
            out_e.append(oe.view(e.shape))
        return tree.unflatten(grads, out_g), tree.unflatten(errors, out_e)
    return sync
