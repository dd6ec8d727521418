"""Losses: next-token cross-entropy (fp32) with z-loss, and the
classification loss.

Port of ``src/repro/train/loss.py``. The reference picks each target's
logit with a one-hot sum over the vocabulary (it keeps a sharded vocab
dim sharded); on one device a gather picks the same fp32 value. Under a
layout (``parallel.layout``) whose logits hold this rank's vocabulary
columns (``parallel.sharding.logits_spec``), :func:`next_token_loss` is
vocabulary-parallel: the max, the sum of exponentials and the picked
label logit are all-reduced over ``model``, so every rank has the
whole-vocabulary loss.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import layout as lay_mod

IGNORE = -1


def next_token_loss(c: ModelConfig, logits: torch.Tensor,
                    labels: torch.Tensor, z_coef: float = 0.0,
                    denom: torch.Tensor | None = None):
    """logits: (B, S, V); labels: (B, S) with IGNORE masked. fp32 softmax.
    ``denom`` (0-d) replaces the count of unmasked labels as the mean's
    denominator (a plan step's count over the global microbatch)."""
    lf = logits.float()
    tgt = labels.clamp(0, c.padded_vocab - 1).long()
    lay = lay_mod.current()
    n = lf.shape[-1]
    if lay is not None and lay.tp > 1 and n < c.padded_vocab:
        lse, picked = _vocab_parallel(lay, lf, tgt - lay.tp_rank * n)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        picked = torch.gather(lf, -1, tgt[..., None])[..., 0]
    nll = lse - picked
    mask = (labels != IGNORE).float()
    if denom is None:
        denom = mask.sum().clamp_min(1.0)
    ce = (nll * mask).sum() / denom
    if z_coef:
        ce = ce + z_coef * ((lse * mask) ** 2).sum() / denom
    return ce


def _vocab_parallel(lay, lf: torch.Tensor, ids: torch.Tensor):
    """``(logsumexp, label logit)`` over the whole vocabulary from this
    rank's columns ``lf`` (its labels at ``ids``, in range or not): the
    max all-reduced (no gradient), then the sum of exponentials and the
    picked logit, each all-reduced forward with an identity backward."""
    n = lf.shape[-1]
    m = lay.mesh.all_reduce(lf.detach().amax(dim=-1), "model", op="max")
    se = lay.row(torch.exp(lf - m[..., None]).sum(dim=-1))
    inside = (ids >= 0) & (ids < n)
    picked = torch.gather(lf, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    picked = lay.row(picked * inside.float())
    return m + torch.log(se), picked


def classification_loss(logits: torch.Tensor, labels: torch.Tensor):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()
