"""Attention: GQA / MHA, causal, prefill and paged decode.

Port of ``src/repro/models/attention.py``. ``sdpa`` keeps the
reference's numerics cast for cast: q is scaled in q.dtype, scores are
fp32, the mask bias is ``finfo(float32).min`` (not -inf) and the softmax
weights are cast back to q.dtype before the PV product.

Ported: ``qkv_proj``, ``make_causal_mask``, ``sdpa`` (the reference's
``impl="repeat"`` formulation), ``out_proj``, ``attend``,
``sdpa_chunked_q`` (the q-chunked path above ``CHUNK_THRESHOLD``),
``self_attention`` (the training path), ``cross_attention`` and
``encoder_kv`` (the encdec decoder's cross slots), ``prefill_attention``
(dense and paged-prefix branches),
``_quantized_block_write`` and ``decode_attention`` (its paged branch,
and its dense per-row and shared-position branches), each paged branch
on fp pools and on int8 pools with their scales. The paged branches call
``repro_torch.kernels.ops``, which launches the CUDA kernels for CUDA
tensors; the dense branches go through ``sdpa``, as in the reference.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (
    NEG_INF, apply_rope, dense_init, param_dtype_of,
)

Params = Any

# Score tensors larger than this (elements over the whole batch) switch to
# the memory-bounded q-chunked path.
CHUNK_THRESHOLD = 1 << 31
#: query rows a chunk (the reference's real-pass ``q_chunk``)
Q_CHUNK = 256


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


def sdpa_chunked_q(q, k, v, *, causal: bool, window: Optional[int],
                   q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """Memory-bounded attention: a loop over query chunks, each of which
    materializes only a (B, H, q_chunk, T_vis) score block. Causal with a
    window slices K/V to the ``min(q_chunk + w, t)`` rows the chunk can
    see. With gradients on, each chunk is recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)
    instead of keeping its fp32 softmax. ``sdpa_chunked_q.calls`` counts
    the calls."""
    sdpa_chunked_q.calls += 1
    b, s, h, dh = q.shape
    t = k.shape[1]
    if s % q_chunk:
        raise ValueError(f"{s} query rows are not whole chunks of {q_chunk}")

    def chunk(qi, start: int):
        if causal and window is None:
            mask = make_causal_mask(q_chunk, t, None, q_offset=start,
                                    device=q.device)
            return sdpa(qi, k, v, mask[None, None])
        if causal:
            vis = min(q_chunk + min(window, t), t)
            k0 = min(max(start + q_chunk - vis, 0), t - vis)
            qpos = start + torch.arange(q_chunk, device=q.device)[:, None]
            kpos = k0 + torch.arange(vis, device=q.device)[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - window)
            return sdpa(qi, k[:, k0:k0 + vis], v[:, k0:k0 + vis],
                        mask[None, None])
        return sdpa(qi, k, v, None)

    outs = []
    for start in range(0, s, q_chunk):
        qi = q[:, start:start + q_chunk]
        if torch.is_grad_enabled():
            outs.append(checkpoint(chunk, qi, start, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(chunk(qi, start))
    return torch.cat(outs, dim=1)


sdpa_chunked_q.calls = 0


def attend(c: ModelConfig, q, k, v, *, causal: bool) -> torch.Tensor:
    """Full attention, or the q-chunked path when the score tensor holds
    more than ``CHUNK_THRESHOLD`` elements and the queries are whole
    chunks of ``Q_CHUNK`` (otherwise full ``sdpa``, as the reference
    falls back)."""
    b, s = q.shape[:2]
    t = k.shape[1]
    if b * c.n_heads * s * t > CHUNK_THRESHOLD and s % Q_CHUNK == 0:
        return sdpa_chunked_q(q, k, v, causal=causal, window=c.attn_window)
    mask = None
    if causal:
        mask = make_causal_mask(s, t, c.attn_window, device=q.device)[None, None]
    return sdpa(q, k, v, mask)


def self_attention(c: ModelConfig, p: Params, x: torch.Tensor, *,
                   causal: bool = True,
                   positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training self-attention over the full sequence."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = qkv_proj(c, p, x, positions if c.use_rope else None)
    return out_proj(p, attend(c, q, k, v, causal=causal))


def cross_attention(c: ModelConfig, p: Params, x: torch.Tensor,
                    enc_kv: tuple) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V
    (:func:`encoder_kv`): queries get ``bq``, no RoPE, no mask."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    k, v = enc_kv
    return out_proj(p, sdpa(q, k, v, None))


def encoder_kv(c: ModelConfig, p: Params, enc_out: torch.Tensor):
    """A cross slot's K/V of the encoder output (B, T_enc, D)."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


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
                     pos, *,
                     block_tables: Optional[torch.Tensor] = None,
                     n_kv_blocks: Optional[int] = None,
                     cache_k_scale: Optional[torch.Tensor] = None,
                     cache_v_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One-token decode against a KV cache, which is UPDATED IN PLACE
    (the reference returns new caches instead). x: (B, 1, D). Returns
    out (B, 1, D).

    Paged (``block_tables`` given): cache_k/v are one layer's pools
    ``(n_blocks, bs, Kh, Dh)``; the new token's K/V is written at
    ``(block_tables[b, pos // bs], pos % bs)``. pos: (B,) per-slot
    positions; idle slots park at a position whose table column is the
    trash block 0. Attention walks the first ``n_kv_blocks`` table
    columns through ``kernels.ops.paged_decode_attention``, masked by true
    length pos + 1. ``cache_k_scale``/``cache_v_scale`` (n_blocks, Kh)
    fp32 mark an int8 pool: the token goes in through
    :func:`_quantized_block_write` (the scales updated in place too) and
    the kernel dequantizes with them.

    Dense (no tables): cache_k/v ``(B, T, Kh, Dh)``, through :func:`sdpa`
    as in the reference, where no kernel carries it. ``pos`` is a (B,)
    tensor of per-row positions (the slotted serve engine: a row
    scatter, and a (B, T) mask that also applies the window), or one
    position shared by every row (an int or a 0-d tensor: a slice write,
    and with a window shorter than T attention over the window's slice
    only).
    """
    if block_tables is None:
        return _dense_decode(c, p, x, cache_k, cache_v, pos)
    if pos.ndim != 1:
        raise ValueError("paged decode needs per-slot positions (B,)")
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


def _dense_decode(c: ModelConfig, p: Params, x: torch.Tensor,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pos) -> torch.Tensor:
    """The reference's two dense branches of ``decode_attention``
    (``src/repro/models/attention.py:440-470``), writing in place."""
    b = x.shape[0]
    t = cache_k.shape[1]
    w = c.attn_window
    per_slot = torch.is_tensor(pos) and pos.ndim == 1
    if per_slot:
        positions = pos.long()[:, None]                           # (B, 1)
    else:
        pos = int(pos)
        positions = torch.full((b, 1), pos, dtype=torch.long,
                               device=x.device)
    q, k_new, v_new = qkv_proj(c, p, x, positions if c.use_rope else None)
    if per_slot:
        # independent write position per batch row (slot): row scatter
        rows = torch.arange(b, device=x.device)
        cache_k[rows, positions[:, 0]] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, positions[:, 0]] = v_new[:, 0].to(cache_v.dtype)
        kpos = torch.arange(t, device=x.device)[None, :]
        m = kpos <= positions                                     # (B, T)
        if w is not None and w < t:
            # per-row starts preclude a shared slice; mask instead
            m = m & (kpos > positions - w)
        return out_proj(p, sdpa(q, cache_k, cache_v, m[:, None, None, :]))
    cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)
    if w is not None and w < t:
        start = min(max(pos - w + 1, 0), t - w)
        k_att, v_att = cache_k[:, start:start + w], cache_v[:, start:start + w]
        kpos = torch.arange(start, start + w, device=x.device)
    else:
        k_att, v_att = cache_k, cache_v
        kpos = torch.arange(t, device=x.device)
    mask = (kpos <= pos)[None, None, None, :]
    return out_proj(p, sdpa(q, k_att, v_att, mask))
