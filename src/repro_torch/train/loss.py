"""Losses: next-token cross-entropy (fp32) with z-loss, and the
classification loss.

Port of ``src/repro/train/loss.py``. The reference picks each target's
logit with a one-hot sum over the vocabulary (it keeps a sharded vocab
dim sharded); on one device a gather picks the same fp32 value.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

IGNORE = -1


def next_token_loss(c: ModelConfig, logits: torch.Tensor,
                    labels: torch.Tensor, z_coef: float = 0.0):
    """logits: (B, S, V); labels: (B, S) with IGNORE masked. fp32 softmax."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = labels.clamp(0, c.padded_vocab - 1).long()
    picked = torch.gather(lf, -1, tgt[..., None])[..., 0]
    nll = lse - picked
    mask = (labels != IGNORE).float()
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
