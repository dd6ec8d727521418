"""The arithmetic of the bf16 tensor-core attention kernels, emulated on
the CPU, against the plain versions under the card's gate.

``csrc/attention_mma.cuh`` computes, per 64-key tile and per KV head's
packed rows: bf16 operands, fp32 scores S = Q K^T times ``scale *
log2(e)`` (q is not pre-scaled in bf16), times the K scale of each int8
pool block's columns; an online softmax in base 2 with masked scores at
-inf and zero probability; the fp32 P times the V scale of each int8
block's columns, split into ``P_hi = bf16(P)`` and ``P_lo = bf16(P -
P_hi)``, two products against the same bf16 V, fp32 accumulation; the
output times 1 / l, rounded once to bf16. This file repeats that
arithmetic in torch (fp32 matmuls standing in for the fp32-accumulating
``mma.sync``) and holds it to ``kernels.ref.flash_attention_ref`` and
``kernels.ref.paged_prefill_attention_ref`` run through ``plain_fp32``,
under the gate that ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the kernels to: |err| <= 2**-7 * (1 + |want|) and at most 1 % of
the bf16 outputs differing at all. It also records why P is split: P
rounded once to bf16 misses the 1 % share.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.bench.workloads.kernels import error_metrics, plain_fp32, \
    quantize
from repro_torch.kernels import ref

KEYS = 64                      # keys per K/V tile
LOG2E = 1.4426950408889634
RATIO, SHARE = 2.0 ** -7, 1e-2


def _mma_rows(q, tiles, qpos, scale, *, window, causal, split):
    """One KV head's packed rows q (R, Dh) bf16 at positions qpos (R,)
    over K/V tiles (k, v, kpos, k_col_scale, v_col_scale), k/v bf16 or
    int8 codes (n, Dh). Returns (R, Dh) bf16."""
    qf = q.float()
    r, dh = q.shape
    m = torch.full((r,), -math.inf)
    l = torch.zeros(r)
    o = torch.zeros(r, dh)
    for k, v, kpos, ksc, vsc in tiles:
        s = (qf @ k.float().T) * (scale * LOG2E) * ksc[None, :]
        if causal:
            vis = kpos[None, :] <= qpos[:, None]
            if window is not None:
                vis &= kpos[None, :] > qpos[:, None] - window
            s = s.masked_fill(~vis, -math.inf)
        m_new = torch.maximum(m, s.max(dim=1).values)
        alpha = torch.where(m == -math.inf, torch.zeros(()),
                            torch.exp2(m - m_new))
        p = torch.where(s == -math.inf, torch.zeros(()),
                        torch.exp2(s - m_new[:, None]))
        l = l * alpha + p.sum(dim=1)
        m = m_new
        pv = p * vsc[None, :]
        hi = pv.bfloat16().float()
        o = o * alpha[:, None] + hi @ v.float()
        if split:
            o = o + (pv - hi).bfloat16().float() @ v.float()
    inv = torch.where(l > 0, 1.0 / l, torch.zeros(()))
    return (o * inv[:, None]).bfloat16()


def _pack(x, kh, g):
    """(S, H, Dh) of one batch row -> the KV head kh's packed rows
    r = i * G + g, (S * G, Dh)."""
    return x[:, kh * g:(kh + 1) * g].reshape(-1, x.shape[-1])


def _unpack(rows, s, g):
    return rows.reshape(s, g, -1)


def flash_emulated(q, k, v, *, causal=True, window=None, split=True):
    """q (B, Sq, H, Dh), k/v (B, Skv, Kh, Dh) bf16, the queries the last Sq
    positions: the kernel's arithmetic."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    out = torch.empty_like(q)
    qpos = (torch.arange(sq) + skv - sq).repeat_interleave(g)
    ones = torch.ones(KEYS)
    for bi in range(b):
        for j in range(kh):
            tiles = [(k[bi, t:t + KEYS, j], v[bi, t:t + KEYS, j],
                      torch.arange(t, min(t + KEYS, skv)),
                      ones[:min(KEYS, skv - t)], ones[:min(KEYS, skv - t)])
                     for t in range(0, skv, KEYS)]
            rows = _mma_rows(_pack(q[bi], j, g), tiles, qpos,
                             1.0 / math.sqrt(dh), window=window,
                             causal=causal, split=split)
            out[bi, :, j * g:(j + 1) * g] = _unpack(rows, sq, g)
    return out


def prefill_emulated(q, k_suf, v_suf, k_pool, v_pool, tables, *,
                     window=None, k_scale=None, v_scale=None, split=True):
    """The paged prefill kernel's arithmetic: prefix tiles of 64 keys
    gathered through the table (codes with their block scales on the
    columns), then the suffix's own tiles."""
    b, sq, h, dh = q.shape
    bs, kh = k_pool.shape[1], k_pool.shape[2]
    g = h // kh
    npre = tables.shape[1]
    pre = npre * bs
    out = torch.empty_like(q)
    qpos = (torch.arange(sq) + pre).repeat_interleave(g)
    for bi in range(b):
        blk = tables[bi].long().repeat_interleave(bs)      # (pre,)
        off = torch.arange(pre) % bs
        for j in range(kh):
            kp, vp = k_pool[blk, off, j], v_pool[blk, off, j]
            ksc = (k_scale[blk, j] if k_scale is not None
                   else torch.ones(pre))
            vsc = (v_scale[blk, j] if v_scale is not None
                   else torch.ones(pre))
            tiles = [(kp[t:t + KEYS], vp[t:t + KEYS],
                      torch.arange(t, min(t + KEYS, pre)), ksc[t:t + KEYS],
                      vsc[t:t + KEYS]) for t in range(0, pre, KEYS)]
            tiles += [(k_suf[bi, t:t + KEYS, j], v_suf[bi, t:t + KEYS, j],
                       torch.arange(t, min(t + KEYS, sq)) + pre,
                       torch.ones(min(KEYS, sq - t)),
                       torch.ones(min(KEYS, sq - t)))
                      for t in range(0, sq, KEYS)]
            rows = _mma_rows(_pack(q[bi], j, g), tiles, qpos,
                             1.0 / math.sqrt(dh), window=window, causal=True,
                             split=split)
            out[bi, :, j * g:(j + 1) * g] = _unpack(rows, sq, g)
    return out


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) \
        .bfloat16()


def _gate(got, want):
    m = error_metrics(got, want)
    assert m["max_err_ratio"] <= RATIO, m
    assert m["mismatch_share"] <= SHARE, m
    return m


FLASH = [
    # b, sq, skv, h, kh, causal, window
    (1, 256, 256, 4, 2, True, None),
    (2, 100, 227, 6, 2, True, 70),       # G = 3, ragged tiles, window
    (1, 128, 128, 2, 2, False, None),    # bidirectional
]


@pytest.mark.parametrize("b,sq,skv,h,kh,causal,window", FLASH)
def test_flash_arithmetic_meets_the_card_gate(b, sq, skv, h, kh, causal,
                                              window):
    rng = np.random.default_rng(sq + skv)
    q, k, v = _bf16(rng, b, sq, h, 64), _bf16(rng, b, skv, kh, 64), \
        _bf16(rng, b, skv, kh, 64)
    kw = dict(causal=causal, window=window)
    _gate(flash_emulated(q, k, v, **kw),
          plain_fp32(ref.flash_attention_ref, q, k, v, **kw))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("bs,window", [(16, None), (8, 40)])
def test_prefill_arithmetic_meets_the_card_gate(int8, bs, window):
    """Prefix tiles of 64 / bs blocks through a shuffled table (the last
    row a pad row on the trash block 0), G = 3, a ragged suffix tile."""
    rng = np.random.default_rng(bs + int8)
    b, sq, kh, g, npre = 3, 100, 2, 3, 9
    n_blocks = 1 + b * npre
    q = _bf16(rng, b, sq, kh * g, 64)
    ks, vs = _bf16(rng, b, sq, kh, 64), _bf16(rng, b, sq, kh, 64)
    kp, vp = (_bf16(rng, n_blocks, bs, kh, 64) for _ in range(2))
    kw = dict(window=window)
    if int8:
        kp, kw["k_scale"] = quantize(kp.float())
        vp, kw["v_scale"] = quantize(vp.float())
    tables = torch.from_numpy(rng.permutation(np.arange(1, n_blocks)).reshape(
        b, npre).astype(np.int32))
    tables[-1] = 0
    _gate(prefill_emulated(q, ks, vs, kp, vp, tables, **kw),
          plain_fp32(ref.paged_prefill_attention_ref, q, ks, vs, kp, vp,
                     tables, **kw))


def test_p_rounded_once_to_bf16_misses_the_share_gate():
    """Why P is split: the same causal attention with P rounded once to
    bf16 before P V stays inside one output ulp, but far more than 1 % of
    the outputs differ from the fp32 softmax."""
    rng = np.random.default_rng(0)
    q, k, v = _bf16(rng, 1, 256, 4, 64), _bf16(rng, 1, 256, 2, 64), \
        _bf16(rng, 1, 256, 2, 64)
    want = plain_fp32(ref.flash_attention_ref, q, k, v)
    split = _gate(flash_emulated(q, k, v), want)
    once = error_metrics(flash_emulated(q, k, v, split=False), want)
    assert once["max_err_ratio"] <= RATIO, once
    assert once["mismatch_share"] > SHARE > split["mismatch_share"], \
        (once, split)
