"""Paged prefill attention on the card: wrapper of
``csrc/paged_prefill_attention.cu``.

Counterpart of ``src/repro/kernels/prefill_attention.py::
paged_prefill_attention`` (Pallas kernel ``_prefill_kernel``), fp and
int8 pools; the source file's note says how the design maps the TPU
kernel onto Hopper and what bounds it. The plain version is
``kernels.ref.paged_prefill_attention_ref``.
``paged_prefill_attention.launches`` counts the kernel's launches and
``paged_prefill_attention.launches_int8`` those of them on an int8 pool.

The kernel is chosen by type: bf16 inputs run on the tensor cores
(``mma.sync``, P split into bf16 hi + lo, ``cp.async`` tiles; int8 codes
widened in shared memory, their scales applied to score and probability
columns), for head widths ``BF16_D_HEADS``, a block size that is a
multiple of 8 and 16-byte aligned tensors; fp32 inputs run on the fp32
FMA kernel at any width, since bf16 tensor cores cannot meet the fp32
tolerance. A bf16 call never reaches the FMA kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES, INT8_CODE
from repro_torch.kernels.decode_attention import check_kv_inputs, check_pools
from repro_torch.kernels.flash_attention import check_aligned

#: head widths of the bf16 kernel: every head width of the configs (16
#: reduced, 64 gpt-117m, 96 gpt-800m, 128 llama3.2-3b and gpt-13b) and 32
BF16_D_HEADS = (16, 32, 64, 96, 128)


def paged_prefill_attention(q: torch.Tensor, k_suffix: torch.Tensor,
                            v_suffix: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, tables: torch.Tensor, *,
                            window: Optional[int] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v_suffix: (B, Sq, Kh, Dh); k/v_pool:
    (n_blocks, bs, Kh, Dh), int8 when k/v_scale (n_blocks, Kh) fp32 are
    given; tables: (B, npre) int32 prefix block ids, npre >= 1. Queries
    sit at global positions ``npre * bs + i``. Returns (B, Sq, H, Dh) in
    q.dtype."""
    q = q.contiguous()
    k_suffix, v_suffix = k_suffix.contiguous(), v_suffix.contiguous()
    check_kv_inputs(q, (k_suffix, v_suffix), (tables,))
    pool_code = check_pools(q, k_pool, v_pool, k_scale, v_scale)
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
    if q.dtype == torch.bfloat16:
        if dh not in BF16_D_HEADS or bs % 8:
            raise ValueError(f"the bf16 kernel takes d_head in "
                             f"{BF16_D_HEADS} and a block size that is a "
                             f"multiple of 8, got d_head {dh}, block size "
                             f"{bs}")
        for name, t in (("q", q), ("k_suffix", k_suffix),
                        ("v_suffix", v_suffix), ("k_pool", k_pool),
                        ("v_pool", v_pool)):
            check_aligned(name, t)
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.repro_paged_prefill_attention(
        q.data_ptr(), k_suffix.data_ptr(), v_suffix.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        out.data_ptr(), None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(), b, sq, kh, h // kh,
        dh, bs, tables.shape[1], tables.stride(0),
        -1 if window is None else int(window), 1.0 / math.sqrt(dh),
        DTYPE_CODES[q.dtype], pool_code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    if pool_code == INT8_CODE:
        paged_prefill_attention.launches_int8 += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.launches_int8 = 0
