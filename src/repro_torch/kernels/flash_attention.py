"""Dense GQA flash attention on the card: wrapper of
``csrc/flash_attention.cu``.

Counterpart of ``src/repro/kernels/flash_attention.py::flash_attention``
(Pallas kernel ``_flash_kernel``); the source file's note says how the
design maps the TPU kernel onto Hopper and what bounds it. The kernel
reads the model's ``(B, S, H, Dh)`` layout through strides, so the
reference's transposes (``src/repro/kernels/ops.py:61-67``) and its
``block_q``/``block_k`` tiling arguments have no counterpart. The plain
version is ``kernels.ref.flash_attention_ref``.
``flash_attention.launches`` counts the kernel's launches.

The kernel is chosen by type: bf16 inputs run on the tensor cores
(``mma.sync``, P split into bf16 hi + lo, ``cp.async`` tiles), whose
16-byte copies need 16-byte aligned rows (see :func:`check_aligned`);
fp32 inputs run on the fp32 FMA kernel, since bf16 tensor cores cannot
meet the fp32 tolerance. A bf16 call never reaches the FMA kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES

#: head widths the kernel is instantiated for (the reference's 64 / 128)
D_HEADS = (64, 128)


def check_aligned(name: str, t: torch.Tensor) -> None:
    """The tensor-core kernels copy 16-byte row chunks with ``cp.async``:
    a tensor needs a 16-byte aligned start and strides (of every dim but
    the last, where it has more than one element) of whole 16 bytes.
    Raise otherwise; nothing is copied quietly."""
    es = t.element_size()
    if t.data_ptr() % 16 or any(
            n > 1 and s * es % 16
            for n, s in zip(t.shape[:-1], t.stride()[:-1])):
        raise ValueError(f"{name}: the bf16 kernel needs a 16-byte aligned "
                         f"start and strides of whole 16 bytes, got address "
                         f"{t.data_ptr():#x} and strides {t.stride()} of "
                         f"{es}-byte elements")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, Kh, Dh), H % Kh == 0, any strides
    with a unit last stride. The queries are the last Sq of the Skv
    positions; ``window`` applies only when ``causal``. Returns a
    contiguous (B, Sq, H, Dh) in q.dtype."""
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError(f"CUDA kernel called with a tensor on "
                             f"{t.device}")
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"q/k/v must share one device and type, got "
                            f"{t.dtype} on {t.device} beside q {q.dtype} "
                            f"on {q.device}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"need (B, S, heads, Dh) with a unit last "
                             f"stride, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}; the kernel takes "
                        f"{sorted(map(str, DTYPE_CODES))}")
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if (k.shape != (b, skv, kh, dh) or v.shape != k.shape or h % kh
            or dh not in D_HEADS):
        raise ValueError(f"shape mismatch or unsupported d_head: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}; d_head in {D_HEADS}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_aligned(name, t)
    if causal and sq > skv:
        raise ValueError(f"causal attention needs Sq <= Skv, got {sq} > "
                         f"{skv}: the first queries would see no key")
    if causal and window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        h, kh, dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), -1 if window is None or not causal else int(window),
        1.0 / math.sqrt(dh), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
