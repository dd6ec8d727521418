"""Row RMSNorm on the card: wrapper of ``csrc/rmsnorm.cu``.

Counterpart of ``src/repro/kernels/rmsnorm.py::rmsnorm`` (Pallas kernel
``_rmsnorm_kernel``); the source file's note says how the design maps
the TPU kernel onto Hopper and what bounds it. The plain version is
``kernels.ref.rmsnorm_ref``. ``rmsnorm.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,), fp32 or bf16 whatever x's type. Fused
    RMSNorm over the last dim in fp32; returns x's shape and type."""
    for t in (x, scale):
        if t.device.type != "cuda":
            raise ValueError(f"CUDA kernel called with a tensor on "
                             f"{t.device}")
        if t.device != x.device or t.dtype not in DTYPE_CODES:
            raise TypeError(f"x and scale must be {sorted(map(str, DTYPE_CODES))}"
                            f" on one card, got {t.dtype} on {t.device}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match the "
                         f"last dim of x {tuple(x.shape)}")
    x2 = x.contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x2)
    rows = x2.numel() // d if d else 0
    if rows == 0:
        return out
    lib = _build.load_library()
    err = lib.repro_rmsnorm(
        x2.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
        DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
