"""Attention: GQA / MHA, causal, prefill and paged decode.

Port of ``src/repro/models/attention.py``. ``sdpa`` keeps the
reference's numerics cast for cast: q is scaled in q.dtype, scores are
fp32, the mask bias is ``finfo(float32).min`` (not -inf) and the softmax
weights are cast back to q.dtype before the PV product.

Ported: ``qkv_proj``, ``make_causal_mask``, ``sdpa`` (the reference's
``impl="repeat"`` formulation), ``out_proj``, ``attend`` (unchunked),
``prefill_attention`` (dense and paged-prefix branches),
``_quantized_block_write`` and ``decode_attention`` (paged branch), each
paged branch on fp pools and on int8 pools with their scales. The paged
branches call ``repro_torch.kernels.ops``, which launches the CUDA
kernels for CUDA tensors. Not yet ported, each raising
``NotImplementedError``: the q-chunked path (``sdpa_chunked_q``) and the
slotted and scalar-position decode branches.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (
    NEG_INF, apply_rope, dense_init, param_dtype_of,
)

Params = Any

# Score tensors larger than this switch to the q-chunked path in the
# reference; the port has not ported that path yet.
CHUNK_THRESHOLD = 1 << 31


def attn_init(gen, c: ModelConfig, lead=()) -> Params:
    pd = param_dtype_of(c)
    wo = dense_init(gen, c.n_heads * c.d_head, c.d_model, pd, lead)
    p = {
        "wq": dense_init(gen, c.d_model, (c.n_heads, c.d_head), pd, lead),
        "wk": dense_init(gen, c.d_model, (c.n_kv_heads, c.d_head), pd, lead),
        "wv": dense_init(gen, c.d_model, (c.n_kv_heads, c.d_head), pd, lead),
        # stored (H, Dh, D): contraction over (H, Dh)
        "wo": wo.reshape(*lead, c.n_heads, c.d_head, c.d_model),
    }
    if c.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((*lead, c.n_heads, c.d_head), dtype=pd,
                              device=dev)
        p["bk"] = torch.zeros((*lead, c.n_kv_heads, c.d_head), dtype=pd,
                              device=dev)
        p["bv"] = torch.zeros((*lead, c.n_kv_heads, c.d_head), dtype=pd,
                              device=dev)
    return p


def qkv_proj(c: ModelConfig, p: Params, x: torch.Tensor,
             positions: Optional[torch.Tensor] = None):
    """x: (B, S, D) -> q (B,S,H,Dh), k/v (B,S,Kh,Dh) with RoPE applied."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if c.use_rope and positions is not None:
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
    return q, k, v


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, neg)


def make_causal_mask(s: int, t: int, window: Optional[int] = None,
                     q_offset: int = 0, device=None) -> torch.Tensor:
    """(s, t) bool mask. Query i (global pos q_offset+i) sees key j<=pos."""
    qpos = torch.arange(s, device=device)[:, None] + q_offset
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,S,H,Dh); k,v: (B,T,Kh,Dh); mask broadcastable to (B,1,S,T)
    or None (bidirectional). fp32 softmax; K/V heads are repeated to H."""
    h, dh = q.shape[2], q.shape[3]
    kh = k.shape[2]
    scale = 1.0 / torch.sqrt(
        torch.full((), dh, dtype=torch.float32, device=q.device)).to(q.dtype)
    q = q * scale
    if h != kh:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    scores = torch.einsum("bshk,bthk->bhst", q, k).float()
    if mask is not None:
        scores = scores + _mask_bias(mask)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", w, v)


def out_proj(p: Params, attn_out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", attn_out, p["wo"])


def attend(c: ModelConfig, q, k, v, *, causal: bool) -> torch.Tensor:
    """Full (unchunked) attention; the reference's q-chunked path for
    score tensors above ``CHUNK_THRESHOLD`` is not ported yet."""
    b, s = q.shape[:2]
    t = k.shape[1]
    if b * c.n_heads * s * t > CHUNK_THRESHOLD:
        raise NotImplementedError(
            "sdpa_chunked_q (score tensors above CHUNK_THRESHOLD) is not "
            "ported yet: ROADMAP Queue 1 item 3")
    mask = None
    if causal:
        mask = make_causal_mask(s, t, c.attn_window, device=q.device)[None, None]
    return sdpa(q, k, v, mask)


def prefill_attention(c: ModelConfig, p: Params, x: torch.Tensor, *,
                      positions: Optional[torch.Tensor] = None,
                      paged_prefix: Optional[tuple] = None):
    """Causal self-attention that also returns the suffix K/V.

    ``paged_prefix`` = (k_pool, v_pool, k_scale, v_scale, tables): the
    queries are suffix tokens at global positions ``npre * bs + i`` (the
    caller passes RoPE ``positions`` with that offset) and attend over
    [the ``npre`` prefix blocks that ``tables`` (B, npre) names in the
    pool ++ their own K/V] through ``kernels.ops.paged_prefill_attention``;
    scales (n_blocks, Kh) that are not None mark an int8 pool.
    """
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = qkv_proj(c, p, x, positions if c.use_rope else None)
    if paged_prefix is not None:
        k_pool, v_pool, k_scale, v_scale, tables = paged_prefix
        out = kops.paged_prefill_attention(q, k, v, k_pool, v_pool, tables,
                                           window=c.attn_window,
                                           k_scale=k_scale, v_scale=v_scale)
        return out_proj(p, out.to(q.dtype)), (k, v)
    return out_proj(p, attend(c, q, k, v, causal=True)), (k, v)


def _quantized_block_write(pool: torch.Tensor, scale: torch.Tensor,
                           new: torch.Tensor, blk: torch.Tensor,
                           off: torch.Tensor) -> None:
    """Write one token (B, Kh, Dh) into int8 pool blocks at
    ``(blk[b], off[b])``, IN PLACE on ``pool`` (n_blocks, bs, Kh, Dh) and
    ``scale`` (n_blocks, Kh): dequantize each owning block under its old
    scale, place the token, re-quantize under ``max(old scale,
    maxabs(new) / 127)``. The scale is monotone, so when the token fits
    the old range the block's other codes are bit-unchanged. The old
    scale and codes are read before anything is written, and codes and
    scale go to the same ``blk``. Duplicate ``blk`` entries only occur on
    the trash block 0 (idle slots), where which write wins is harmless.
    Same arithmetic as the reference, op for op."""
    newf = new.float()
    osc = scale[blk]                                          # (B, Kh)
    deq = pool[blk].float() * osc[:, None, :, None]           # (B,bs,Kh,Dh)
    rows = torch.arange(new.shape[0], device=new.device)
    deq[rows, off] = newf
    nsc = torch.maximum(osc, newf.abs().amax(dim=-1) / 127.0)
    div = torch.where(nsc > 0.0, nsc, torch.ones_like(nsc))
    q = torch.round(deq / div[:, None, :, None])
    pool[blk] = q.clamp(-127, 127).to(pool.dtype)
    scale[blk] = nsc


def decode_attention(c: ModelConfig, p: Params, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor, *,
                     block_tables: Optional[torch.Tensor] = None,
                     n_kv_blocks: Optional[int] = None,
                     cache_k_scale: Optional[torch.Tensor] = None,
                     cache_v_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One-token decode against the paged KV pool.

    x: (B, 1, D); cache_k/v: one layer's pools ``(n_blocks, bs, Kh, Dh)``,
    UPDATED IN PLACE: the new token's K/V is written at
    ``(block_tables[b, pos // bs], pos % bs)`` (the reference returns new
    pools instead). pos: (B,) int per-slot positions; idle slots park at a
    position whose table column is the trash block 0. Attention walks the
    first ``n_kv_blocks`` table columns, masked by true length pos + 1.
    ``cache_k_scale``/``cache_v_scale`` (n_blocks, Kh) fp32 mark an int8
    pool: the token goes in through :func:`_quantized_block_write` (the
    scales updated in place too) and the kernel dequantizes with them.
    Returns out (B, 1, D).
    """
    if block_tables is None:
        raise NotImplementedError(
            "slotted decode is not ported yet: ROADMAP Queue 1 item 3")
    if pos.ndim != 1:
        raise NotImplementedError(
            "scalar-position decode is not ported yet: ROADMAP Queue 1 "
            "item 3")
    q, k_new, v_new = qkv_proj(c, p, x, pos[:, None] if c.use_rope else None)
    bs = cache_k.shape[1]
    nb = n_kv_blocks if n_kv_blocks is not None else block_tables.shape[1]
    blk = block_tables.gather(1, (pos // bs)[:, None].long())[:, 0].long()
    off = (pos % bs).long()
    if cache_k_scale is not None:
        _quantized_block_write(cache_k, cache_k_scale, k_new[:, 0], blk, off)
        _quantized_block_write(cache_v, cache_v_scale, v_new[:, 0], blk, off)
    else:
        cache_k[blk, off] = k_new[:, 0].to(cache_k.dtype)
        cache_v[blk, off] = v_new[:, 0].to(cache_v.dtype)
    out = kops.paged_decode_attention(q[:, 0], cache_k, cache_v,
                                      block_tables[:, :nb], pos + 1,
                                      window=c.attn_window,
                                      k_scale=cache_k_scale,
                                      v_scale=cache_v_scale)
    return out_proj(p, out[:, None].to(q.dtype))
