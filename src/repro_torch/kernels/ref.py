"""Plain PyTorch versions of the port's kernels.

Port of ``src/repro/kernels/ref.py``: ``flash_attention_ref``,
``rmsnorm_ref``, ``dequantize_pool`` (with the int8 pool's scales) and
the two paged attention oracles, each on fp pools and on int8 pools with
their (n_blocks, Kh) scales; besides, ``batchnorm_ref`` with its
epilogues (the reference's BatchNorm is array code, with no kernel).
These define what the CUDA kernels compute: the CPU path of
``kernels.ops`` runs them, and the card-side checks compare each kernel
with them on the same inputs. ``ssd_chunk_ref`` is
the oracle of the SSD scan (``models.ssm.ssd_chunked``), which has no
kernel, in the reference as here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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


#: BatchNorm's epilogues: none, ReLU, and the shortcut added before ReLU
BN_ACTS = ("none", "relu", "add_relu")


def bn_epilogue(y: torch.Tensor, act: str,
                residual: Optional[torch.Tensor]) -> torch.Tensor:
    """``y``, ``relu(y)`` or ``relu(y + residual)`` in y's type; the
    shortcut goes with ``add_relu`` alone."""
    if act not in BN_ACTS:
        raise ValueError(f"act must be one of {BN_ACTS}, got {act!r}")
    if (act == "add_relu") != (residual is not None):
        raise ValueError(f"act {act!r} with residual "
                         f"{'given' if residual is not None else 'None'}: "
                         f"the shortcut goes with add_relu alone")
    if residual is not None:
        y = y + residual
    return y if act == "none" else F.relu(y)


def batchnorm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  *, act: str = "none",
                  residual: Optional[torch.Tensor] = None,
                  eps: float = 1e-5) -> torch.Tensor:
    """Batch-statistics BatchNorm of ``x`` (N, C, H, W) over (N, H, W) in
    fp32 with the biased variance, cast to x.dtype, then the epilogue
    ``act`` (:func:`bn_epilogue`)."""
    y = F.batch_norm(x.float(), None, None, scale.float(), bias.float(),
                     training=True, eps=eps).to(x.dtype)
    return bn_epilogue(y, act, residual)


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


def ssd_chunk_ref(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, h0: torch.Tensor):
    """Single-chunk SSD: within-chunk quadratic + carried-in state.

    xdt: (L, H, P); dA: (L, H); B/C: (L, N); h0: (H, P, N). Returns
    (y (L, H, P), h_out (H, P, N)), fp32 math. ``exp`` is evaluated
    above the diagonal too (then masked to 0), where it can overflow: an
    oracle for forward values only, never differentiated (a backward
    through it gives ``inf * 0 = NaN``).
    """
    l = xdt.shape[0]
    f = torch.float32
    dA_cs = torch.cumsum(dA.to(f), dim=0)                        # (L, H)
    ss = dA_cs[:, None, :] - dA_cs[None, :, :]                   # (L, L, H)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=xdt.device))
    decay = torch.where(mask[..., None], torch.exp(ss),
                        torch.zeros((), dtype=f, device=xdt.device))
    scores = torch.einsum("ln,sn->ls", C.to(f), B.to(f))
    y_intra = torch.einsum("ls,lsh,shp->lhp", scores, decay, xdt.to(f))
    y_carry = torch.einsum("ln,hpn,lh->lhp", C.to(f), h0.to(f),
                           torch.exp(dA_cs))
    decay_to_end = torch.exp(dA_cs[-1][None] - dA_cs)            # (L, H)
    h_out = (h0.to(f) * torch.exp(dA_cs[-1])[:, None, None]
             + torch.einsum("ln,lh,lhp->hpn", B.to(f), decay_to_end,
                            xdt.to(f)))
    return (y_intra + y_carry).to(xdt.dtype), h_out.to(h0.dtype)
