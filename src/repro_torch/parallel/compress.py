"""Gradient compression: int8 quantization with error feedback.

Port of ``src/repro/parallel/compress.py``, the arithmetic of one
participant. The reference's ``compressed_psum`` runs inside
``shard_map`` and reduces over a mesh axis (``pmax`` of the scales,
``psum`` of the int32 codes); the port runs on one device, where both
reductions are the identity, so ``compressed_psum`` here takes no axis.
Its tensor may hold several equal-sized buckets along its leading dims:
each row of the last dim gets its own scale, from one reduction.
"""
from __future__ import annotations

from typing import Optional

import torch


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8. Returns (q, scale)."""
    amax = x.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(x: torch.Tensor, error: Optional[torch.Tensor] = None):
    """int8 mean over a world of one, with error feedback. Returns
    ``(mean-reduced x, new_error)``, one scale per row of the last dim."""
    xf = x.float()
    if error is not None:
        xf = xf + error
    scale = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    new_error = xf - q * scale          # residual kept locally
    # psum of the int32 codes over one participant, then / n with n = 1
    out = q.to(torch.int32).float() * scale / 1.0
    return out, new_error
