"""Paged decode attention on the card: wrapper of
``csrc/paged_decode_attention.cu``.

Counterpart of ``src/repro/kernels/decode_attention.py::
paged_decode_attention`` (Pallas kernel ``_decode_kernel``); the source
file's note says how the design maps the TPU kernel onto Hopper and what
bounds it. The plain version is ``kernels.ref.paged_decode_attention_ref``.
``paged_decode_attention.launches`` counts the kernel's launches and
``paged_decode_attention.launches_int8`` those of them on an int8 pool.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES, INT8_CODE


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
    for t in (k_pool, v_pool, k_scale, v_scale):
        if t.device != q.device or not t.is_contiguous():
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
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.repro_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        b, kh, h // kh, dh, bs, tables.shape[1], tables.stride(0),
        -1 if window is None else int(window), 1.0 / math.sqrt(dh),
        DTYPE_CODES[q.dtype], pool_code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    if pool_code == INT8_CODE:
        paged_decode_attention.launches_int8 += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_int8 = 0
