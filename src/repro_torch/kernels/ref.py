"""Plain PyTorch versions of the port's kernels.

Port of ``src/repro/kernels/ref.py``: ``flash_attention_ref``,
``rmsnorm_ref``, ``dequantize_pool`` (with the int8 pool's scales) and
the two paged attention oracles, each on fp pools and on int8 pools with
their (n_blocks, Kh) scales. These define what the CUDA kernels compute:
the CPU path of ``kernels.ops`` runs them, and the card-side checks
compare each kernel with them on the same inputs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = torch.finfo(torch.float32).min


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, Kh, Dh), H % Kh == 0 (GQA). The
    queries are the last Sq of the Skv positions; ``window`` applies only
    when ``causal``. fp32 softmax; returns (B, Sq, H, Dh) in q.dtype."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.float() * (1.0 / dh ** 0.5)
    qg = qf.reshape(b, sq, kh, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask = mask & (kpos > qpos - window)
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm over the last dim in fp32, ``x * rsqrt(mean(x**2) +
    eps) * scale``, cast to x.dtype."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def dequantize_pool(pool: torch.Tensor, tables: torch.Tensor,
                    pool_scale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Gather ``pool[tables]`` -> (B, nb, bs, Kh, Dh) fp32, applying the
    per-block-per-head symmetric scales ``(n_blocks, Kh)`` when the pool
    is int8-quantized (``pool_scale`` given)."""
    idx = tables.long()
    g = pool[idx].float()
    if pool_scale is not None:
        g = g * pool_scale[idx][:, :, None, :, None].float()
    return g


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, tables: torch.Tensor,
                               lengths: torch.Tensor, *,
                               window: Optional[int] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Single-token GQA decode attention over a paged KV pool.

    q: (B, H, Dh); k/v_pool: (n_blocks, bs, Kh, Dh), int8 codes when
    ``k_scale``/``v_scale`` (n_blocks, Kh) fp32 are given (both or
    neither; dequantized right after the gather); tables: (B, nb) int32
    physical block ids in position order (unowned columns point at the
    trash block 0); lengths: (B,) int32 KV length including the current
    token. Visible keys: kpos < length, and kpos > length-1-window when
    windowed. fp32 softmax; returns (B, H, Dh) in q.dtype.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale are given both or neither")
    b, h, dh = q.shape
    nb = tables.shape[1]
    bs, kh = k_pool.shape[1], k_pool.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(dh)
    k = dequantize_pool(k_pool, tables, k_scale).reshape(b, nb * bs, kh, dh)
    v = dequantize_pool(v_pool, tables, v_scale).reshape(b, nb * bs, kh, dh)
    qf = q.float().reshape(b, kh, g, dh) * scale
    scores = torch.einsum("bkgd,btkd->bkgt", qf, k)
    kpos = torch.arange(nb * bs, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    mask = kpos < lens
    if window is not None:
        mask = mask & (kpos > lens - 1 - window)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, v)
    return out.reshape(b, h, dh).to(q.dtype)


def paged_prefill_attention_ref(q: torch.Tensor, k_suffix: torch.Tensor,
                                v_suffix: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, tables: torch.Tensor, *,
                                window: Optional[int] = None,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Chunk-of-queries causal GQA attention over [paged prefix ++ own
    suffix K/V].

    q: (B, Sq, H, Dh) at global positions ``npre * bs + i``; k/v_suffix:
    (B, Sq, Kh, Dh); k/v_pool: (n_blocks, bs, Kh, Dh), int8 when
    ``k_scale``/``v_scale`` (n_blocks, Kh) fp32 are given (dequantized
    right after the gather, then rounded to the suffix's type); tables:
    (B, npre) int32 prefix block ids in position order (whole blocks of
    real tokens). Returns (B, Sq, H, Dh) in q.dtype.

    The arithmetic REPLICATES ``models.attention.sdpa`` on the concatenated dense view, cast for
    cast, so that a prefix-cache hit yields the same token stream as a
    cold prefill of the whole prompt. Keep the two in step.
    """
    b, sq, h, dh = q.shape
    npre = tables.shape[1]
    bs, kh = k_pool.shape[1], k_pool.shape[2]
    pos_offset = npre * bs
    native = k_suffix.dtype
    pk = dequantize_pool(k_pool, tables, k_scale).reshape(
        b, pos_offset, kh, dh)
    pv = dequantize_pool(v_pool, tables, v_scale).reshape(
        b, pos_offset, kh, dh)
    k = torch.cat([pk.to(native), k_suffix], dim=1)
    v = torch.cat([pv.to(native), v_suffix], dim=1)
    t = pos_offset + sq
    sc = 1.0 / torch.sqrt(
        torch.full((), dh, dtype=torch.float32, device=q.device)).to(q.dtype)
    qs = q * sc
    if h != kh:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    scores = torch.einsum("bshk,bthk->bhst", qs, k).float()
    qpos = torch.arange(sq, device=q.device)[:, None] + pos_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    scores = scores + torch.where(mask, zero, neg)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", w, v)
