"""Every model input of a dry-run cell as a ``meta`` tensor.

Port of ``src/repro/launch/specs.py``: shapes and dtypes with no storage,
which the dry run traces its programs against. The modality front ends
are stubs, as in the reference: whisper takes precomputed frame
embeddings, llava precomputed patch embeddings. The reference attaches
each input's production sharding; these specs are for one device and
take no plan (multi-device placement is ROADMAP Queue 1 item 8, which
brings the plan).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models.common import dtype_of
from repro_torch.serve.cache import slotted_cache

Params = Any
META = torch.device("meta")


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_params(c: ModelConfig) -> Params:
    """Shape-only params (``lm.init_abstract``); one device, no plan
    (item 8)."""
    return lm.init_abstract(c)


def _side_inputs(c: ModelConfig, b: int) -> dict:
    out = {}
    if c.family == "vlm":
        out["patch_embeds"] = _empty((b, c.n_patches, c.d_model), dtype_of(c))
    if c.family == "encdec":
        out["enc_frames"] = _empty((b, c.enc_seq, c.d_model), dtype_of(c))
    return out


def train_batch_specs(c: ModelConfig, shape: ShapeConfig) -> dict:
    """The train step's batch; one device, no plan (item 8)."""
    b, s = shape.global_batch, shape.seq_len
    s_text = s - (c.n_patches if c.family == "vlm" else 0)
    return {"tokens": _empty((b, s_text), torch.int32),
            "labels": _empty((b, s_text), torch.int32),
            **_side_inputs(c, b)}


def prefill_specs(c: ModelConfig, shape: ShapeConfig):
    """(tokens, extras) of the prefill; one device, no plan (item 8)."""
    b, s = shape.global_batch, shape.seq_len
    s_text = s - (c.n_patches if c.family == "vlm" else 0)
    return _empty((b, s_text), torch.int32), _side_inputs(c, b)


def decode_specs(c: ModelConfig, shape: ShapeConfig, aps: Params):
    """(token, caches, pos, enc_kv) of the decode step; one device, no
    plan (item 8). The caches are the slotted cache's rows at the
    cell's batch and length, the shapes and dtypes a prefill of the
    cell emits (``serve.cache.abstract_caches``, which the tests hold
    them equal to) built without tracing a 32k prefill; an encdec
    model's cross K/V come from its encoder traced on ``meta``."""
    b, s = shape.global_batch, shape.seq_len
    caches = slotted_cache(c, b, s, device=META)
    enc_kv = None
    if c.family == "encdec":
        with torch.no_grad():
            enc_kv = lm.encode(c, aps, _side_inputs(c, b)["enc_frames"])[1]
    token = _empty((b, 1), torch.int32)
    pos = _empty((), torch.int32)
    return token, caches, pos, enc_kv
