"""Decoder blocks over layer-stacked parameters, dense family.

Port of ``src/repro/models/blocks.py`` (``stack_prefill`` and
``stack_decode``). The reference scans over the stacked layer leaves;
here a Python loop indexes them. Parameters keep the reference's tree,
``{"slot0": {...}}`` with leading axis ``n_layers`` (a dense stack has a
period of one layer). Paged caches stay stacked as
``(L, n_blocks, bs, Kh, Dh)`` (int8 pools with ``(L, n_blocks, Kh)``
scale leaves beside them) and decode updates them in place.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import apply_mlp, apply_norm

Params = Any


def check_family(c: ModelConfig) -> None:
    if c.family != "dense":
        raise NotImplementedError(
            f"family {c.family!r} is not ported yet: ROADMAP Queue 1 "
            "item 10 (the port runs dense decoders)")


def layer(tree: Params, i: int) -> Params:
    """Layer ``i``'s view of a stacked tree (leaves indexed, no copy)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def _ffn(c: ModelConfig, sp: Params, x: torch.Tensor) -> torch.Tensor:
    if c.d_ff:
        x = x + apply_mlp(c, sp["mlp"], apply_norm(c, sp["norm2"], x))
    return x


def stack_prefill(c: ModelConfig, layers: Params, x: torch.Tensor, *,
                  positions: Optional[torch.Tensor] = None,
                  paged_prefix: Params = None,
                  paged_tables: Optional[torch.Tensor] = None):
    """Full-sequence causal pass that also emits per-layer K/V.

    ``paged_prefix`` is the pool cache tree (k/v leaves
    ``(L, n_blocks, bs, Kh, Dh)``, plus k/v_scale leaves on an int8 pool)
    and ``paged_tables`` (B, npre) each row's prefix block ids: attention
    then runs the paged prefill kernel against the prefix held in the
    pool. Returns (x, caches) with caches ``{"slot0": {"k", "v"}}`` of
    shape (L, B, S, Kh, Dh).
    """
    check_family(c)
    stack = layers["slot0"]
    n_layers = stack["norm1"]["scale"].shape[0]
    ks, vs = [], []
    for i in range(n_layers):
        sp = layer(stack, i)
        h = apply_norm(c, sp["norm1"], x)
        pp = None
        if paged_prefix is not None:
            pool = paged_prefix["slot0"]
            pp = (pool["k"][i], pool["v"][i], *_scales(pool, i),
                  paged_tables)
        h, (k, v) = attn.prefill_attention(c, sp["attn"], h,
                                           positions=positions,
                                           paged_prefix=pp)
        ks.append(k)
        vs.append(v)
        x = _ffn(c, sp, x + h)
    return x, {"slot0": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def stack_decode(c: ModelConfig, layers: Params, x: torch.Tensor,
                 caches: Params, pos: torch.Tensor, *,
                 block_tables: Optional[torch.Tensor] = None,
                 n_kv_blocks: Optional[int] = None):
    """One-token decode through the stack; every layer writes its token
    into its own pool slice (and, on an int8 pool, its scale slice) and
    reads the same ``(B, max_blocks)`` block table. Returns (x, caches) —
    the caches object itself, updated."""
    check_family(c)
    stack = layers["slot0"]
    pool = caches["slot0"]
    for i in range(pool["k"].shape[0]):
        sp = layer(stack, i)
        h = apply_norm(c, sp["norm1"], x)
        k_scale, v_scale = _scales(pool, i)
        h = attn.decode_attention(c, sp["attn"], h, pool["k"][i],
                                  pool["v"][i], pos,
                                  block_tables=block_tables,
                                  n_kv_blocks=n_kv_blocks,
                                  cache_k_scale=k_scale,
                                  cache_v_scale=v_scale)
        x = _ffn(c, sp, x + h)
    return x, caches


def _scales(pool: Params, i: int) -> tuple:
    """Layer ``i``'s (k_scale, v_scale) views of an int8 pool, or
    (None, None) for an fp pool."""
    if "k_scale" not in pool:
        return None, None
    return pool["k_scale"][i], pool["v_scale"][i]
