"""Paged decode attention on the card: wrapper of
``csrc/paged_decode_attention.cu``.

Counterpart of ``src/repro/kernels/decode_attention.py::
paged_decode_attention`` (Pallas kernel ``_decode_kernel``); the source
file's note says how the design maps the TPU kernel onto Hopper and what
bounds it. The plain version is ``kernels.ref.paged_decode_attention_ref``.
``paged_decode_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES


def check_kv_inputs(q: torch.Tensor, pools, index_tensors) -> None:
    """Shared argument checks of the paged kernels' wrappers."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}; the kernels take "
                        f"{sorted(map(str, DTYPE_CODES))}")
    for t in pools:
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"KV tensor {t.dtype} on {t.device} does not "
                            f"match q {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError("KV tensors must be contiguous")
    for t in index_tensors:
        if t.device != q.device or t.dtype != torch.int32:
            raise TypeError(f"index tensor must be int32 on {q.device}, "
                            f"got {t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError("index tensors need a unit last stride")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Dh); k/v_pool: (n_blocks, bs, Kh, Dh); tables: (B, nb)
    int32 (a column slice of a wider table is fine: rows may be
    strided); lengths: (B,) int32 KV length including the current token.
    Returns (B, H, Dh) in q.dtype."""
    if not q.is_contiguous() or q.dim() != 3:
        raise ValueError(f"q must be a contiguous (B, H, Dh), got "
                         f"{tuple(q.shape)}")
    check_kv_inputs(q, (k_pool, v_pool), (tables, lengths))
    b, h, dh = q.shape
    n_blocks, bs, kh, dh_kv = k_pool.shape
    if v_pool.shape != k_pool.shape or dh_kv != dh or h % kh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.repro_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, kh, h // kh, dh, bs, tables.shape[1], tables.stride(0),
        -1 if window is None else int(window), 1.0 / math.sqrt(dh),
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
