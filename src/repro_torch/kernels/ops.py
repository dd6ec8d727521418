"""Dispatch of the port's kernel ops by the tensors' device.

Port of ``src/repro/kernels/ops.py``. A CPU tensor takes the plain
PyTorch version (``kernels.ref``); a CUDA tensor launches the
hand-written kernel, whose wrapper raises on anything it does not take —
there is no switch that picks the plain version on the card, and no
fallback to it when a kernel fails to build or launch. The reference's
``block_q``/``block_k`` arguments are the Pallas kernels' tiling, not
part of the functions, and have no counterpart.

Each kernel wrapper keeps a plain integer launch counter
(``<wrapper>.launches``); :func:`launch_counts` reads them all and
:func:`reset_launch_counts` zeroes them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import batchnorm as _batchnorm
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import prefill_attention as _prefill
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm

#: op name -> CUDA wrapper (the owner of the launch counter)
KERNELS = {
    "paged_decode_attention": _decode.paged_decode_attention,
    "paged_prefill_attention": _prefill.paged_prefill_attention,
    "flash_attention": _flash.flash_attention,
    "rmsnorm": _rmsnorm.rmsnorm,
    "adamw": _adamw.adamw,
    "batchnorm": _batchnorm.batchnorm,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    _decode.paged_decode_attention.launches_int8 = 0
    _prefill.paged_prefill_attention.launches_int8 = 0
    _rmsnorm.rmsnorm.launches_vector = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Dense GQA flash attention in the model layout. q: (B, Sq, H, Dh);
    k/v: (B, Skv, Kh, Dh); the queries are the last Sq positions;
    ``window`` applies only when ``causal``."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def paged_decode_attention(q: torch.Tensor, k_pool, v_pool, tables, lengths,
                           *, window: Optional[int] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-token GQA decode over a paged KV pool. q: (B, H, Dh);
    k/v_pool: (n_blocks, bs, Kh, Dh); tables: (B, nb) int32 block ids;
    lengths: (B,) int32 KV length including the current token;
    k/v_scale: optional (n_blocks, Kh) fp32 scales of an int8 pool."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, k_pool, v_pool, tables, lengths, window=window,
            k_scale=k_scale, v_scale=v_scale)
    return _decode.paged_decode_attention(
        q, k_pool, v_pool, tables, lengths, window=window, k_scale=k_scale,
        v_scale=v_scale)


def paged_prefill_attention(q: torch.Tensor, k_suffix, v_suffix, k_pool,
                            v_pool, tables, *,
                            window: Optional[int] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Chunk-of-queries causal GQA attention over [paged prefix ++ own
    suffix K/V]. q: (B, Sq, H, Dh); k/v_suffix: (B, Sq, Kh, Dh);
    tables: (B, npre) int32 prefix block ids; k/v_scale: optional
    (n_blocks, Kh) fp32 scales of an int8 pool."""
    if q.device.type == "cpu":
        return ref.paged_prefill_attention_ref(
            q, k_suffix, v_suffix, k_pool, v_pool, tables, window=window,
            k_scale=k_scale, v_scale=v_scale)
    return _prefill.paged_prefill_attention(
        q, k_suffix, v_suffix, k_pool, v_pool, tables, window=window,
        k_scale=k_scale, v_scale=v_scale)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm over the last dim. x: (..., D); scale: (D,)."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps)
    return _rmsnorm.rmsnorm(x, scale, eps=eps)


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              act: str = "none", residual: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    """Training-mode BatchNorm of ``x`` (N, C, H, W; channels_last on the
    card) from the batch's statistics, then the epilogue ``act``: none,
    ``"relu"``, or ``"add_relu"``, which adds ``residual`` to the output
    rounded to x's type before the ReLU. Differentiable."""
    if x.device.type == "cpu":
        return ref.batchnorm_ref(x, scale, bias, act=act, residual=residual,
                                 eps=eps)
    return _batchnorm.batchnorm(x, scale, bias, act=act, residual=residual,
                                eps=eps)
