"""Dispatch of the paged attention ops by the tensors' device.

Port of ``src/repro/kernels/ops.py``. A CPU tensor takes the plain
PyTorch version (``kernels.ref``); a CUDA tensor launches the
hand-written kernel, whose wrapper raises on anything it does not take —
there is no switch that picks the plain version on the card.

Each kernel wrapper keeps a plain integer launch counter
(``<wrapper>.launches``); :func:`launch_counts` reads them all and
:func:`reset_launch_counts` zeroes them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import prefill_attention as _prefill
from repro_torch.kernels import ref

#: op name -> CUDA wrapper (the owner of the launch counter)
KERNELS = {
    "paged_decode_attention": _decode.paged_decode_attention,
    "paged_prefill_attention": _prefill.paged_prefill_attention,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def paged_decode_attention(q: torch.Tensor, k_pool, v_pool, tables, lengths,
                           *, window: Optional[int] = None) -> torch.Tensor:
    """Single-token GQA decode over a paged KV pool. q: (B, H, Dh);
    k/v_pool: (n_blocks, bs, Kh, Dh); tables: (B, nb) int32 block ids;
    lengths: (B,) int32 KV length including the current token."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, tables,
                                              lengths, window=window)
    return _decode.paged_decode_attention(q, k_pool, v_pool, tables,
                                          lengths, window=window)


def paged_prefill_attention(q: torch.Tensor, k_suffix, v_suffix, k_pool,
                            v_pool, tables, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """Chunk-of-queries causal GQA attention over [paged prefix ++ own
    suffix K/V]. q: (B, Sq, H, Dh); k/v_suffix: (B, Sq, Kh, Dh);
    tables: (B, npre) int32 prefix block ids."""
    if q.device.type == "cpu":
        return ref.paged_prefill_attention_ref(q, k_suffix, v_suffix, k_pool,
                                               v_pool, tables, window=window)
    return _prefill.paged_prefill_attention(q, k_suffix, v_suffix, k_pool,
                                            v_pool, tables, window=window)
