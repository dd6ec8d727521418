"""Decoder-only language model: the dense, moe, ssm and hybrid families.

Port of ``src/repro/models/lm.py``: ``init`` (the port's own seeded
initializer, drawing the reference's distributions from a
``torch.Generator``), ``forward`` (training: ``remat`` and ``impl`` as in
the reference; returns the MoE aux loss summed over the stack),
``prefill`` and ``decode_step``. The encdec and vlm families raise
``NotImplementedError`` (``blocks.check_family``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks
from repro_torch.models.common import (
    apply_norm, embed_tokens, embedding_init, norm_init, unembed,
)

Params = Any


def init(c: ModelConfig, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> Params:
    """Random parameters with the reference's tree, layouts and
    distributions (not its random bits). ``device`` defaults to the CUDA
    card; ``generator`` defaults to one seeded with 0 on that device."""
    blocks.check_family(c)
    dev = resolve_device(device)
    gen = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    layers = blocks.stack_init(gen, c)
    return {"embed": embedding_init(gen, c), "layers": layers,
            "final_norm": norm_init(c, dev)}


def _embed(c: ModelConfig, p: Params, tokens: torch.Tensor,
           pos_offset: int = 0) -> torch.Tensor:
    positions = torch.arange(tokens.shape[1],
                             device=tokens.device)[None, :] + pos_offset
    return embed_tokens(c, p["embed"], tokens, positions)


def forward(c: ModelConfig, p: Params, tokens: torch.Tensor, *,
            impl: str = "repeat", remat: str = "full"):
    """Full causal forward over (B, S) tokens -> (logits, aux_loss), the
    training path (``blocks.stack_forward``: no caches; aux_loss sums the
    MoE slots' load-balancing losses, 0 without MoE)."""
    x, aux = blocks.stack_forward(c, p["layers"], _embed(c, p, tokens),
                                  causal=True, impl=impl, remat=remat)
    x = apply_norm(c, p["final_norm"], x)
    return unembed(c, p["embed"], x), aux


def prefill(c: ModelConfig, p: Params, tokens: torch.Tensor, *,
            last_pos: Optional[torch.Tensor] = None,
            pos_offset: int = 0, paged_prefix: Params = None,
            paged_tables: Optional[torch.Tensor] = None):
    """Process a (right-padded) prompt batch; return (logits at each
    row's ``last_pos`` — default the last column —, per-layer caches).

    ``paged_prefix`` + ``paged_tables`` + ``pos_offset`` select the
    prefix-cached suffix prefill: ``tokens`` holds only the suffix (global
    positions start at ``pos_offset = npre * block_size``), the prefix
    K/V stays in the pool and attention walks ``paged_tables`` (B, npre).
    The returned caches cover only the suffix.
    """
    has_prefix = paged_prefix is not None
    if has_prefix != (pos_offset > 0):
        raise ValueError(f"pos_offset={pos_offset} needs paged_prefix "
                         "(and only then)")
    x = _embed(c, p, tokens, pos_offset)
    positions = None
    if has_prefix:
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :] + pos_offset
    x, caches = blocks.stack_prefill(c, p["layers"], x,
                                     positions=positions,
                                     paged_prefix=paged_prefix,
                                     paged_tables=paged_tables)
    if last_pos is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, last_pos.long()][:, None]
    else:
        x_last = x[:, -1:]
    x_last = apply_norm(c, p["final_norm"], x_last)
    return unembed(c, p["embed"], x_last), caches


def decode_step(c: ModelConfig, p: Params, token: torch.Tensor,
                caches: Params, pos, *,
                block_tables: Optional[torch.Tensor] = None,
                n_kv_blocks: Optional[int] = None):
    """token: (B, 1); pos: (B,) per-slot positions, or one position
    shared by every row (an int or a 0-d tensor; dense caches only).
    ``block_tables`` selects the paged pools, else ``caches`` holds dense
    rows (the slotted cache). The caches are updated in place. Returns
    (logits, caches)."""
    if torch.is_tensor(pos) and pos.ndim == 1:
        positions = pos[:, None]
    else:
        positions = torch.full_like(token, int(pos))
    x = embed_tokens(c, p["embed"], token, positions)
    x, caches = blocks.stack_decode(c, p["layers"], x, caches, pos,
                                    block_tables=block_tables,
                                    n_kv_blocks=n_kv_blocks)
    x = apply_norm(c, p["final_norm"], x)
    return unembed(c, p["embed"], x), caches
