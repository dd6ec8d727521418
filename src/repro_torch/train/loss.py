"""Losses: next-token cross-entropy (fp32) with z-loss, and the
classification loss.

Port of ``src/repro/train/loss.py``. The reference picks each target's
logit with a one-hot sum over the vocabulary (it keeps a sharded vocab
dim sharded); on one device a gather picks the same fp32 value.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig

IGNORE = -1


def next_token_loss(c: ModelConfig, logits: torch.Tensor,
                    labels: torch.Tensor, z_coef: float = 0.0,
                    denom: torch.Tensor | None = None):
    """logits: (B, S, V); labels: (B, S) with IGNORE masked. fp32 softmax.
    ``denom`` (0-d) replaces the count of unmasked labels as the mean's
    denominator (a dp step's :func:`token_denoms`)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = labels.clamp(0, c.padded_vocab - 1).long()
    picked = torch.gather(lf, -1, tgt[..., None])[..., 0]
    nll = lse - picked
    mask = (labels != IGNORE).float()
    if denom is None:
        denom = mask.sum().clamp_min(1.0)
    ce = (nll * mask).sum() / denom
    if z_coef:
        ce = ce + z_coef * ((lse * mask) ** 2).sum() / denom
    return ce


def classification_loss(logits: torch.Tensor, labels: torch.Tensor):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()


def token_denoms(labels: torch.Tensor, k: int, group) -> torch.Tensor:
    """The loss denominators of a dp step whose loss is the token mean
    over every rank's rows (GSPMD's loss over a sharded batch): for each
    of ``k`` microbatches of this rank's ``labels``, the unmasked labels
    of all ranks of ``group`` over the group's size. With them the mean
    over ranks of the ranks' losses, and of their gradients, is that
    global token mean for any counts. One all-reduce of ``k`` numbers;
    nothing is read back to the host."""
    n = (labels != IGNORE).reshape(k, -1).sum(1, dtype=torch.float32)
    dist.all_reduce(n, group=group)
    return n.clamp_min(1.0) / dist.get_world_size(group)
