"""Every model input of a dry-run cell as a ``meta`` tensor.

Port of ``src/repro/launch/specs.py``: shapes and dtypes with no storage,
which the dry run traces its programs against. The modality front ends
are stubs, as in the reference: whisper takes precomputed frame
embeddings, llava precomputed patch embeddings. The reference attaches
each input's production sharding; these specs are for one device and
take an optional plan (``parallel.sharding``): with one, each input has
this rank's local shape, the shape rank 0 of a production mesh holds:
params cut to its shards (``Zero1.shard``), batch rows by
``batch_spec`` (the train batch: its rows of each microbatch in turn,
the input bytes the dry run's peak counts; the traced step takes the
global rows and cuts them, as on the ranks), caches by ``cache_spec``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models.common import dtype_of
from repro_torch.parallel import layout as layout_mod
from repro_torch.parallel import sharding as shd
from repro_torch.serve.cache import slotted_cache

Params = Any
META = torch.device("meta")


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_params(c: ModelConfig) -> Params:
    """Shape-only params (``lm.init_abstract``); a rank's shards of them
    are ``sharding.Zero1(plan, whole, c).shard(whole)``."""
    return lm.init_abstract(c)


def local_rows(plan, rows: int) -> int:
    """This rank's rows of ``rows`` global rows under ``batch_spec``."""
    if plan is None:
        return rows
    part = shd.batch_spec(plan, (rows,))[0]
    return rows // plan.mesh.axes_size(shd._axes_of(part)) if part \
        else rows


def _side_inputs(c: ModelConfig, b: int) -> dict:
    out = {}
    if c.family == "vlm":
        out["patch_embeds"] = _empty((b, c.n_patches, c.d_model), dtype_of(c))
    if c.family == "encdec":
        out["enc_frames"] = _empty((b, c.enc_seq, c.d_model), dtype_of(c))
    return out


def train_batch_specs(c: ModelConfig, shape: ShapeConfig, plan=None,
                      k: int = 1) -> dict:
    """The train step's batch: whole, or under ``plan`` this rank's rows
    of each of ``k`` microbatches of ``global_batch / k`` rows."""
    b, s = shape.global_batch, shape.seq_len
    b = k * local_rows(plan, b // k)
    s_text = s - (c.n_patches if c.family == "vlm" else 0)
    return {"tokens": _empty((b, s_text), torch.int32),
            "labels": _empty((b, s_text), torch.int32),
            **_side_inputs(c, b)}


def prefill_specs(c: ModelConfig, shape: ShapeConfig, plan=None):
    """(tokens, extras) of the prefill (this rank's rows under ``plan``)."""
    b, s = local_rows(plan, shape.global_batch), shape.seq_len
    s_text = s - (c.n_patches if c.family == "vlm" else 0)
    return _empty((b, s_text), torch.int32), _side_inputs(c, b)


def _cut(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """Rank ``mesh.rank``'s block of ``t`` under ``spec``."""
    for d, part in enumerate(spec):
        axes = shd._axes_of(part)
        n = mesh.axes_size(axes) if axes else 1
        if n > 1:
            rows = t.shape[d] // n
            t = t.narrow(d, mesh.index(axes) * rows, rows)
    return t.clone()


def decode_specs(c: ModelConfig, shape: ShapeConfig, aps: Params,
                 plan=None, layout=None):
    """(token, caches, pos, enc_kv) of the decode step. The caches are
    the slotted cache's rows at the cell's batch and length, the shapes
    and dtypes a prefill of the cell emits (``serve.cache.
    abstract_caches``, which the tests hold them equal to) built without
    tracing a 32k prefill, cut by ``cache_spec`` under ``plan``; an
    encdec model's cross K/V come from its encoder traced on ``meta``
    (under ``layout``, from ``aps``, this rank's shards)."""
    b, s = shape.global_batch, shape.seq_len
    caches = slotted_cache(c, b, s, device=META)
    if plan is not None:
        caches = {slot: {name: _cut(t, shd.cache_spec(c, plan, (slot, name),
                                                      tuple(t.shape)),
                                    plan.mesh)
                         for name, t in leaves.items()}
                  for slot, leaves in caches.items()}
        b = local_rows(plan, b)
    enc_kv = None
    if c.family == "encdec":
        with torch.no_grad(), layout_mod.use(layout):
            enc_kv = lm.encode(c, aps, _side_inputs(c, b)["enc_frames"])[1]
    token = _empty((b, 1), torch.int32)
    pos = _empty((), torch.int32)
    return token, caches, pos, enc_kv
