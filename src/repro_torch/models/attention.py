"""Attention: GQA / MHA, causal, prefill and paged decode.

Port of ``src/repro/models/attention.py``. ``sdpa`` keeps the
reference's numerics cast for cast: q is scaled in q.dtype, scores are
fp32, the mask bias is ``finfo(float32).min`` (not -inf) and the softmax
weights are cast back to q.dtype before the PV product.

Ported: ``qkv_proj``, ``make_causal_mask``, ``sdpa`` (both of the
reference's formulations: ``impl="repeat"`` repeats K/V to the H query
heads, ``impl="grouped"`` contracts queries grouped as (Kh, G) against
the Kh K/V heads without repeating them), ``out_proj``, ``attend``,
``sdpa_chunked_q`` (the q-chunked path above ``CHUNK_THRESHOLD``),
``self_attention`` (the training path), ``cross_attention`` and
``encoder_kv`` (the encdec decoder's cross slots), ``prefill_attention``
(dense and paged-prefix branches),
``_quantized_block_write`` and ``decode_attention`` (its paged branch,
and its dense per-row and shared-position branches), each paged branch
on fp pools and on int8 pools with their scales. The paged branches call
``repro_torch.kernels.ops``, which launches the CUDA kernels for CUDA
tensors; the dense branches go through ``sdpa``, as in the reference.
``impl`` takes the reference's defaults: ``"repeat"`` for training,
prefill and cross-attention, ``"grouped"`` for decode.
:func:`skip_attention_core` zeroes the attention core of :func:`attend`
(the reference's perf probe, used by ``launch.hillclimb``).
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (
    NEG_INF, apply_rope, dense_init, param_dtype_of, recomputed,
)
from repro_torch.parallel import layout as lay_mod

Params = Any

# Score tensors larger than this (elements over the whole batch) switch to
# the memory-bounded q-chunked path.
CHUNK_THRESHOLD = 1 << 31
#: query rows a chunk (the reference's real-pass ``q_chunk``)
Q_CHUNK = 256

#: sdpa's two einsum formulations
IMPLS = ("repeat", "grouped")

# Perf probe: replace the attention CORE (scores, softmax, PV) of
# ``attend`` with zeros and keep the projections, so that counting a
# program with and without it isolates attention's share.
_SKIP_CORE: ContextVar[bool] = ContextVar("attn_skip_core", default=False)


@contextlib.contextmanager
def skip_attention_core():
    tok = _SKIP_CORE.set(True)
    try:
        yield
    finally:
        _SKIP_CORE.reset(tok)


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
         mask: Optional[torch.Tensor], impl: str = "repeat") -> torch.Tensor:
    """q: (B,S,H,Dh); k,v: (B,T,Kh,Dh); mask broadcastable to (B,1,S,T)
    or None (bidirectional). fp32 softmax. ``impl="repeat"`` repeats the
    K/V heads to H; ``"grouped"`` views q as (B,S,Kh,G,Dh) and contracts
    each group against its K/V head (equal to repeat where H == Kh)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}: one of {IMPLS}")
    b, s, h, dh = q.shape
    kh = k.shape[2]
    scale = 1.0 / torch.sqrt(
        torch.full((), dh, dtype=torch.float32, device=q.device)).to(q.dtype)
    q = q * scale
    if impl == "repeat" or h == kh:
        if h != kh:
            k = k.repeat_interleave(h // kh, dim=2)
            v = v.repeat_interleave(h // kh, dim=2)
        scores = torch.einsum("bshk,bthk->bhst", q, k).float()
        if mask is not None:
            scores = scores + _mask_bias(mask)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhst,bthk->bshk", w, v)
    qg = q.reshape(b, s, kh, h // kh, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    if mask is not None:
        scores = scores + _mask_bias(mask)[:, None]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", w, v).reshape(b, s, h, dh)


def out_proj(p: Params, attn_out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", attn_out, p["wo"])


def sdpa_chunked_q(q, k, v, *, causal: bool, window: Optional[int],
                   impl: str = "repeat",
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
            return sdpa(qi, k, v, mask[None, None], impl)
        if causal:
            vis = min(q_chunk + min(window, t), t)
            k0 = min(max(start + q_chunk - vis, 0), t - vis)
            qpos = start + torch.arange(q_chunk, device=q.device)[:, None]
            kpos = k0 + torch.arange(vis, device=q.device)[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - window)
            return sdpa(qi, k[:, k0:k0 + vis], v[:, k0:k0 + vis],
                        mask[None, None], impl)
        return sdpa(qi, k, v, None, impl)

    outs = []
    for start in range(0, s, q_chunk):
        qi = q[:, start:start + q_chunk]
        if torch.is_grad_enabled():
            outs.append(recomputed(chunk, qi, start))
        else:
            outs.append(chunk(qi, start))
    return torch.cat(outs, dim=1)


sdpa_chunked_q.calls = 0


def attend(c: ModelConfig, q, k, v, *, causal: bool,
           impl: str = "repeat") -> torch.Tensor:
    """Full attention, or the q-chunked path when the score tensor holds
    more than ``CHUNK_THRESHOLD`` elements and the queries are whole
    chunks of ``Q_CHUNK`` (otherwise full ``sdpa``, as the reference
    falls back). Under :func:`skip_attention_core` the core is zeros
    (kept dependent on k and v, as the reference's probe keeps it)."""
    b, s = q.shape[:2]
    t = k.shape[1]
    if _SKIP_CORE.get():
        return torch.zeros_like(q) + 0.0 * (
            k[:, :1].sum() + v[:, :1].sum()).to(q.dtype)
    if b * c.n_heads * s * t > CHUNK_THRESHOLD and s % Q_CHUNK == 0:
        return sdpa_chunked_q(q, k, v, causal=causal, window=c.attn_window,
                              impl=impl)
    mask = None
    if causal:
        mask = make_causal_mask(s, t, c.attn_window, device=q.device)[None, None]
    return sdpa(q, k, v, mask, impl)


def _head_split(c: ModelConfig, p: Params):
    """The current layout when it splits this attention's heads over
    ``model`` (``wo`` holds the rank's heads), else None."""
    lay = lay_mod.current()
    if lay is None or lay.tp == 1 or p["wo"].shape[-3] == c.n_heads:
        return None
    return lay


def _local_kv(c: ModelConfig, lay, k: torch.Tensor, v: torch.Tensor):
    """K/V computed whole on every rank (``Kh`` does not divide tp): pass
    them into the split compute (their gradient summed over the ranks)
    and keep, one per query head of this rank, the K/V head it reads
    under GQA."""
    if k.shape[2] < c.n_kv_heads:
        return k, v          # already this rank's heads
    g = c.n_heads // k.shape[2]
    k, v = lay.col(k), lay.col(v)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return lay.local(k, 2), lay.local(v, 2)


def _heads(lay, t: torch.Tensor) -> torch.Tensor:
    """This rank's heads (dim -2) of a gathered (heads, Dh) weight or a
    replicated bias; the gradient of the rest is zero here and is summed
    over the ranks (the weight's gather, the bias's ``col``)."""
    return lay.local(t, -2)


def _kv_split(c: ModelConfig, lay) -> bool:
    return c.n_kv_heads % lay.tp == 0


def _tp_qkv(c: ModelConfig, p: Params, xc: torch.Tensor, x: torch.Tensor,
            positions, lay, raw: bool = False):
    """q of this rank's heads; k/v of its heads (``Kh`` divides tp) or
    computed whole and cut to the heads its queries read (``raw``: also
    the K/V before that cut, what a cache keeps). ``xc, x`` are the
    input's views for split and whole compute (``Layout.enter``)."""
    q = torch.einsum("bsd,dhk->bshk", xc, _heads(lay, p["wq"]))
    if "bq" in p:
        q = q + _heads(lay, lay.col(p["bq"]))
    if _kv_split(c, lay):
        k = torch.einsum("bsd,dhk->bshk", xc, _heads(lay, p["wk"]))
        v = torch.einsum("bsd,dhk->bshk", xc, _heads(lay, p["wv"]))
        if "bk" in p:
            k = k + _heads(lay, lay.col(p["bk"]))
            v = v + _heads(lay, lay.col(p["bv"]))
    else:
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
    if c.use_rope and positions is not None:
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
    if raw:
        return (q, *_local_kv(c, lay, k, v), k, v)
    k, v = _local_kv(c, lay, k, v)
    return q, k, v


def _cache_cut(c: ModelConfig, lay, t: torch.Tensor) -> torch.Tensor:
    """A layout's share of new K/V rows (B, S, Kh, Dh) as
    ``sharding.cache_spec`` keeps them: the K/V heads over ``model``
    when they divide it, else the head dim when it does."""
    if lay is None or lay.tp == 1 or t.shape[2] < c.n_kv_heads:
        return t
    if c.n_kv_heads % lay.tp == 0:
        return lay.local(t, 2)
    if c.d_head % lay.tp == 0:
        return lay.local(t, 3)
    return t


def self_attention(c: ModelConfig, p: Params, x: torch.Tensor, *,
                   causal: bool = True,
                   positions: Optional[torch.Tensor] = None,
                   impl: str = "repeat") -> torch.Tensor:
    """Training self-attention over the full sequence. Under a layout
    that splits the heads (``wq`` holds this rank's), the rank attends
    with its heads and the output projection's partial sums are
    all-reduced (Megatron's head parallelism); under sequence
    parallelism ``x`` holds the rank's rows of the sequence, all-gathered
    on the way in and reduce-scattered on the way out
    (``Layout.enter`` / ``exit``; ``whole_in`` / ``whole_out`` around
    attention every tp rank computes whole)."""
    lay = _head_split(c, p)
    if lay is not None:
        xc, x = lay.enter(x)
    else:
        x = lay_mod.whole_in(x)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if lay is not None:
        q, k, v = _tp_qkv(c, p, xc, x, positions if c.use_rope else None,
                          lay)
        return lay.exit(out_proj(p, attend(c, q, k, v, causal=causal,
                                           impl=impl)))
    q, k, v = qkv_proj(c, p, x, positions if c.use_rope else None)
    return lay_mod.whole_out(out_proj(p, attend(c, q, k, v, causal=causal,
                                                impl=impl)))


def cross_attention(c: ModelConfig, p: Params, x: torch.Tensor,
                    enc_kv: tuple, impl: str = "repeat") -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V
    (:func:`encoder_kv`): queries get ``bq``, no RoPE, no mask."""
    lay = _head_split(c, p)
    k, v = enc_kv
    if lay is not None:
        q = torch.einsum("bsd,dhk->bshk", lay.enter(x)[0],
                         _heads(lay, p["wq"]))
        if "bq" in p:
            q = q + _heads(lay, lay.col(p["bq"]))
        k, v = _local_kv(c, lay, k, v)
        return lay.exit(out_proj(p, sdpa(q, k, v, None, impl)))
    q = torch.einsum("bsd,dhk->bshk", lay_mod.whole_in(x), p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    return lay_mod.whole_out(out_proj(p, sdpa(q, k, v, None, impl)))


def encoder_kv(c: ModelConfig, p: Params, enc_out: torch.Tensor):
    """A cross slot's K/V of the encoder output (B, T_enc, D): under a
    layout that splits the K/V heads, this rank's heads."""
    lay = _head_split(c, p)
    if lay is not None and _kv_split(c, lay):
        enc_out = lay.col(enc_out)
        k = torch.einsum("bsd,dhk->bshk", enc_out, _heads(lay, p["wk"]))
        v = torch.einsum("bsd,dhk->bshk", enc_out, _heads(lay, p["wv"]))
        if "bk" in p:
            k = k + _heads(lay, lay.col(p["bk"]))
            v = v + _heads(lay, lay.col(p["bv"]))
        return k, v
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def prefill_attention(c: ModelConfig, p: Params, x: torch.Tensor, *,
                      positions: Optional[torch.Tensor] = None,
                      impl: str = "repeat",
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
    lay = lay_mod.current()
    if lay is not None and paged_prefix is None:
        # a layout's prefill: the training path's split, caches cut
        split = _head_split(c, p)
        if split is not None:
            q, k, v, k_raw, v_raw = _tp_qkv(
                c, p, *split.enter(x), positions if c.use_rope else None,
                lay, raw=True)
            out = lay.row(out_proj(p, attend(c, q, k, v, causal=True,
                                             impl=impl)))
        else:
            q, k_raw, v_raw = qkv_proj(c, p, x,
                                       positions if c.use_rope else None)
            out = out_proj(p, attend(c, q, k_raw, v_raw, causal=True,
                                     impl=impl))
        return out, (_cache_cut(c, lay, k_raw), _cache_cut(c, lay, v_raw))
    q, k, v = qkv_proj(c, p, x, positions if c.use_rope else None)
    if paged_prefix is not None:
        k_pool, v_pool, k_scale, v_scale, tables = paged_prefix
        out = kops.paged_prefill_attention(q, k, v, k_pool, v_pool, tables,
                                           window=c.attn_window,
                                           k_scale=k_scale, v_scale=v_scale)
        return out_proj(p, out.to(q.dtype)), (k, v)
    return out_proj(p, attend(c, q, k, v, causal=True, impl=impl)), (k, v)


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
                     pos, *, impl: str = "grouped",
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
    only). ``impl`` is the dense branches' ``sdpa`` formulation; the
    paged kernel is grouped by construction.
    """
    if block_tables is None:
        lay = lay_mod.current()
        if lay is not None and (lay.tp > 1 or lay.cache_seq_axis):
            return _sharded_decode(c, p, x, cache_k, cache_v, pos, lay)
        return _dense_decode(c, p, x, cache_k, cache_v, pos, impl)
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


def _sharded_decode(c: ModelConfig, p: Params, x: torch.Tensor,
                    cache_k: torch.Tensor, cache_v: torch.Tensor, pos,
                    lay) -> torch.Tensor:
    """One-token decode at one shared position ``pos`` against this
    rank's share of dense caches (``sharding.cache_spec``): K/V heads
    over ``model`` (the rank attends with the query heads they serve),
    or the head dim over ``model`` (every query head's partial scores on
    the rank's ``Dh`` slice, all-reduced, and the output's ``Dh`` slices
    all-gathered), and the sequence over ``lay.cache_seq_axis`` for a
    long-context batch (a softmax whose max, sum and PV product are
    all-reduced over that axis; the rank holding ``pos`` writes the new
    token). The reference's decode hint keeps the heads whole against
    such a cache; here the rank's heads go through ``wo`` as in
    training, and the output projection's partial sums are all-reduced.
    The caches are updated in place."""
    if torch.is_tensor(pos) and pos.ndim:
        raise ValueError("a sharded decode takes one shared position")
    pos = int(pos)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    rope = positions if c.use_rope else None
    split = _head_split(c, p)
    if split is not None:
        q, _k, _v, k_new, v_new = _tp_qkv(c, p, *lay.enter(x), rope, lay,
                                          raw=True)
    else:
        q, k_new, v_new = qkv_proj(c, p, x, rope)
    kv_split = cache_k.shape[2] < c.n_kv_heads
    dh_split = cache_k.shape[3] < c.d_head
    t_loc = cache_k.shape[1]
    seq = lay.cache_seq_axis
    t0 = lay.mesh.index(seq) * t_loc if seq else 0
    if t0 <= pos < t0 + t_loc:          # this rank holds the position
        cache_k[:, pos - t0] = _cache_cut(c, lay, k_new)[:, 0].to(
            cache_k.dtype)
        cache_v[:, pos - t0] = _cache_cut(c, lay, v_new)[:, 0].to(
            cache_v.dtype)
    k, v = cache_k, cache_v
    if dh_split:
        if split is not None:        # every head's partial scores
            q = lay.mesh.all_gather(q, "model", 2)
        q = lay.local(q, 3)
    elif split is not None and not kv_split:
        k, v = _local_kv(c, lay, k, v)
    hq, kh = q.shape[2], k.shape[2]
    scale = 1.0 / torch.sqrt(torch.full((), c.d_head, dtype=torch.float32,
                                        device=q.device)).to(q.dtype)
    qg = (q * scale).reshape(b, 1, kh, hq // kh, q.shape[3])
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    if dh_split:
        scores = lay.mesh.all_reduce(scores, "model")
    kpos = t0 + torch.arange(t_loc, device=x.device)
    m = kpos <= pos
    if c.attn_window is not None:
        m = m & (kpos > pos - c.attn_window)
    scores = scores + _mask_bias(m)
    if seq:
        mx = lay.mesh.all_reduce(scores.amax(-1, keepdim=True), seq,
                                 op="max")
        e = torch.exp(scores - mx)
        w = (e / lay.mesh.all_reduce(e.sum(-1, keepdim=True), seq)).to(
            q.dtype)
        out = lay.mesh.all_reduce(torch.einsum("bkgst,btkd->bskgd", w, v),
                                  seq)
    else:
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", w, v)
    out = out.reshape(b, 1, hq, v.shape[3])
    if dh_split:
        out = lay.mesh.all_gather(out, "model", 3)
        if split is not None:
            out = lay.local(out, 2)
    if split is not None:
        return lay.row(out_proj(p, out))
    return out_proj(p, out)


def _dense_decode(c: ModelConfig, p: Params, x: torch.Tensor,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pos, impl: str) -> torch.Tensor:
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
        return out_proj(p, sdpa(q, cache_k, cache_v, m[:, None, None, :],
                                impl))
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
    return out_proj(p, sdpa(q, k_att, v_att, mask, impl))
