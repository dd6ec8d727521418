"""Paged decode attention on the card: wrapper of
``csrc/paged_decode_attention.cu``.

Counterpart of ``src/repro/kernels/decode_attention.py::
paged_decode_attention`` (Pallas kernel ``_decode_kernel``); the source
file's note says how the design maps the TPU kernel onto Hopper and what
bounds it. The plain version is ``kernels.ref.paged_decode_attention_ref``.
``paged_decode_attention.launches`` counts the kernel's launches and
``paged_decode_attention.launches_int8`` those of them on an int8 pool.

The kernel splits each sequence's table columns across thread blocks
(:func:`decode_splits` picks how many from host-known numbers only, the
columns a split owns from the whole table's width, so that a row's
result does not depend on the bucket of columns a call passes) and
combines the splits in the same launch: one call is one launch. It takes
head widths ``D_HEADS`` and 16-byte aligned q and pools.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES, INT8_CODE

#: head widths the kernel is instantiated for: every width of the
#: configs (16 reduced, 64 gpt-117m, 96 gpt-800m, 128 llama3.2-3b) and 32;
#: each is whole 16-byte vectors of bf16, fp32 and int8
D_HEADS = (16, 32, 64, 96, 128)
#: query heads one thread block carries (``kMaxG`` in the source: G = 3
#: at llama3.2-3b width); a larger GQA group takes ceil(G / 3) blocks per
#: KV head
HEADS_PER_BLOCK = 3
#: most splits of one sequence (``kMaxSplits`` in the source)
MAX_SPLITS = 64
#: blocks per SM that the split count aims at: several, since the splits
#: past a sequence's length (the table is a power-of-two bucket of the
#: longest one) exit at once
TARGET_BLOCKS_PER_SM = 8
#: B x Kh x head chunks at which the card counts as full without a split
FULL_BLOCKS_PER_SM = 2


def decode_splits(batch: int, kv_heads: int, nb: int, sms: int, *,
                  group: int = 1,
                  width: Optional[int] = None) -> tuple[int, int]:
    """(splits, chunk): how many blocks share one sequence's table of
    ``nb`` columns, each owning ``chunk`` consecutive columns (the last
    split may own fewer). Host-known numbers only (batch, KV heads, the
    table width and the SM count), never the lengths, so choosing costs
    no synchronisation. One split where B x Kh (x head chunks) already
    fills the card; never more splits than columns.

    ``width`` (default ``nb``) is the column count of the whole table
    when ``nb`` columns of it are passed (the engine buckets ``nb`` to
    its longest live slot): the chunk is chosen for ``width``, so a
    row's partition into splits, and with it the order of its softmax
    sums, is the same whatever bucket the other rows make; the splits
    past a row's length add nothing to its combine."""
    w = max(nb, width or 0)
    pairs = batch * kv_heads * -(-group // HEADS_PER_BLOCK)
    if w <= 1 or pairs >= FULL_BLOCKS_PER_SM * sms:
        return 1, w
    splits = min(w, MAX_SPLITS, -(-TARGET_BLOCKS_PER_SM * sms // pairs))
    chunk = -(-w // splits)
    return max(-(-nb // chunk), 1), chunk


def _plan(state: _build.StreamState, b: int, kh: int, g: int, dh: int,
          nb: int, width: int, splits: Optional[int]) -> tuple:
    """(splits, chunk, scratch pointer, tickets pointer) of a call, kept
    in the stream's ``state``."""
    key = (b, kh, g, dh, nb, width, splits)
    plan = state.plans.get(key)
    if plan is None:
        if splits is None:
            splits, chunk = decode_splits(b, kh, nb, state.sms, group=g,
                                          width=width)
        elif 1 <= splits <= MAX_SPLITS:
            chunk = -(-nb // splits)
        else:
            raise ValueError(f"splits must be in [1, {MAX_SPLITS}], got "
                             f"{splits}")
        pairs = b * kh * -(-g // HEADS_PER_BLOCK)
        tickets = state.tickets_ptr(pairs)
        need = pairs * splits * HEADS_PER_BLOCK * (dh + 2) \
            if splits > 1 else 0
        plan = state.plans[key] = (
            splits, chunk, state.scratch_ptr(need) if need else None,
            tickets)
    return plan


#: each (card, stream)'s tickets, scratch and plans (``_build.StreamState``)
_STATES: dict = {}


def check_kv_inputs(q: torch.Tensor, pools, index_tensors) -> None:
    """Shared argument checks of the paged kernels' wrappers (devices
    compared by index: -1 off the card)."""
    if not q.is_cuda:
        raise ValueError(f"CUDA kernel called with a tensor on {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}; the kernels take "
                        f"{sorted(map(str, DTYPE_CODES))}")
    dev = q.get_device()
    for t in pools:
        if t.get_device() != dev or t.dtype != q.dtype:
            raise TypeError(f"KV tensor {t.dtype} on {t.device} does not "
                            f"match q {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError("KV tensors must be contiguous")
    for t in index_tensors:
        if t.get_device() != dev or t.dtype != torch.int32:
            raise TypeError(f"index tensor must be int32 on {q.device}, "
                            f"got {t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError("index tensors need a unit last stride")


def check_pools(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor]) -> int:
    """The pool rule of both paged kernels: a pool of q's type without
    scales, or a pool with (n_blocks, Kh) fp32 contiguous scales (int8
    codes, or q's type as the reference allows). Returns the pool's type
    code."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale are given both or neither")
    if k_scale is None:
        check_kv_inputs(q, (k_pool, v_pool), ())
        return DTYPE_CODES[q.dtype]
    if k_pool.dtype != v_pool.dtype or k_pool.dtype not in (q.dtype,
                                                            torch.int8):
        raise TypeError(f"pools {k_pool.dtype} / {v_pool.dtype} with scales:"
                        f" need int8 or q's {q.dtype}")
    want = (k_pool.shape[0], k_pool.shape[2])
    dev = q.get_device()
    for t in (k_pool, v_pool, k_scale, v_scale):
        if t.get_device() != dev or not t.is_contiguous():
            raise ValueError(f"pools and scales must be contiguous tensors "
                             f"on {q.device}, got a {tuple(t.shape)} tensor "
                             f"on {t.device} with strides {t.stride()}")
    for t in (k_scale, v_scale):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise TypeError(f"scales must be fp32 of shape {want}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    return INT8_CODE if k_pool.dtype == torch.int8 else DTYPE_CODES[q.dtype]


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           window: Optional[int] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q: (B, H, Dh); k/v_pool: (n_blocks, bs, Kh, Dh), int8 when
    k/v_scale (n_blocks, Kh) fp32 are given; tables: (B, nb) int32 (a
    column slice of a wider table is fine: rows may be strided);
    lengths: (B,) int32 KV length including the current token. Returns
    (B, H, Dh) in q.dtype."""
    return _paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                   window, k_scale, v_scale, None)


def _paged_decode_attention(q, k_pool, v_pool, tables, lengths, window,
                            k_scale, v_scale,
                            splits: Optional[int]) -> torch.Tensor:
    """:func:`paged_decode_attention` with ``splits`` (1 to
    ``MAX_SPLITS``; the chunk is ceil(nb / splits)) in place of
    :func:`decode_splits`' choice when given: the card tests reach the
    split kernel's edges through it."""
    if not q.is_contiguous() or q.dim() != 3:
        raise ValueError(f"q must be a contiguous (B, H, Dh), got "
                         f"{tuple(q.shape)}")
    check_kv_inputs(q, (), (tables, lengths))
    pool_code = check_pools(q, k_pool, v_pool, k_scale, v_scale)
    b, h, dh = q.shape
    n_blocks, bs, kh, dh_kv = k_pool.shape
    if v_pool.shape != k_pool.shape or dh_kv != dh or h % kh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    if dh not in D_HEADS:
        raise ValueError(f"the decode kernel takes d_head in {D_HEADS}, got "
                         f"{dh}")
    # contiguous rows of whole 16-byte vectors (Dh in D_HEADS): only the
    # start can be off
    if q.data_ptr() % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"the decode kernel needs 16-byte aligned q and "
                         f"pools, got addresses {q.data_ptr():#x}, "
                         f"{k_pool.data_ptr():#x}, {v_pool.data_ptr():#x}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    g, nb = h // kh, tables.shape[1]
    stream = torch.cuda.current_stream(q.get_device()).cuda_stream
    # a column slice of a wider table: its row stride is the full width
    state = _build.stream_state(_STATES, "paged_decode_attention",
                                q.device, stream, 1024)
    splits, chunk, scratch, tickets = _plan(state, b, kh, g, dh, nb,
                                            tables.stride(0), splits)
    err = _build.load_library().repro_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(), scratch, tickets,
        b, kh, g, dh, bs, nb, tables.stride(0),
        -1 if window is None else int(window), splits, chunk,
        1.0 / math.sqrt(dh), DTYPE_CODES[q.dtype], pool_code, stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    if pool_code == INT8_CODE:
        paged_decode_attention.launches_int8 += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_int8 = 0
