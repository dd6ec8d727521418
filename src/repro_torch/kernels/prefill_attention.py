"""Paged prefill attention on the card: wrapper of
``csrc/paged_prefill_attention.cu``.

Counterpart of ``src/repro/kernels/prefill_attention.py::
paged_prefill_attention`` (Pallas kernel ``_prefill_kernel``); the source
file's note says how the design maps the TPU kernel onto Hopper and what
bounds it. The plain version is
``kernels.ref.paged_prefill_attention_ref``.
``paged_prefill_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import DTYPE_CODES, check_kv_inputs


def paged_prefill_attention(q: torch.Tensor, k_suffix: torch.Tensor,
                            v_suffix: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, tables: torch.Tensor, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v_suffix: (B, Sq, Kh, Dh); k/v_pool:
    (n_blocks, bs, Kh, Dh); tables: (B, npre) int32 prefix block ids,
    npre >= 1. Queries sit at global positions ``npre * bs + i``.
    Returns (B, Sq, H, Dh) in q.dtype."""
    q = q.contiguous()
    k_suffix, v_suffix = k_suffix.contiguous(), v_suffix.contiguous()
    check_kv_inputs(q, (k_suffix, v_suffix, k_pool, v_pool), (tables,))
    b, sq, h, dh = q.shape
    n_blocks, bs, kh, dh_kv = k_pool.shape
    if (v_pool.shape != k_pool.shape or dh_kv != dh or h % kh
            or k_suffix.shape != (b, sq, kh, dh)
            or v_suffix.shape != k_suffix.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, suffix "
                         f"{tuple(k_suffix.shape)}, pools "
                         f"{tuple(k_pool.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or tables.shape[1] < 1:
        raise ValueError(f"tables {tuple(tables.shape)}: need (B, npre>=1); "
                         "a cold prefill takes the dense path")
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.repro_paged_prefill_attention(
        q.data_ptr(), k_suffix.data_ptr(), v_suffix.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        out.data_ptr(), b, sq, kh, h // kh, dh, bs, tables.shape[1],
        tables.stride(0), -1 if window is None else int(window),
        1.0 / math.sqrt(dh), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
