"""Row RMSNorm on the card: wrapper of ``csrc/rmsnorm.cu``.

Counterpart of ``src/repro/kernels/rmsnorm.py::rmsnorm`` (Pallas kernel
``_rmsnorm_kernel``); the source file's note says how the design maps
the TPU kernel onto Hopper and what bounds it. The plain version is
``kernels.ref.rmsnorm_ref``. ``rmsnorm.launches`` counts the kernel's
launches and ``rmsnorm.launches_vector`` those of them on the vector
kernel.

Two hand-written kernels, chosen by the tensors' shape and addresses
(:func:`takes_vector_kernel`), never by a failure: rows of whole 16-byte
vectors at 16-byte aligned addresses (and D up to
``MAX_VECTORS_PER_THREAD`` x 128 vectors) take the vector kernel, every
other input the scalar one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES

#: the vector kernel's threads per block and vectors per thread at most
#: (``kVecThreads`` and the largest ``kVpt`` instance in the source)
VECTOR_THREADS = 128
MAX_VECTORS_PER_THREAD = 16
#: blocks per SM of the vector kernel's grid; each walks a share of rows
BLOCKS_PER_SM = 8


def takes_vector_kernel(x: torch.Tensor, scale: torch.Tensor,
                        out: torch.Tensor) -> bool:
    """Whole 16-byte vectors per row at 16-byte aligned addresses, few
    enough to stay in registers."""
    d = x.shape[-1]
    n = 16 // x.element_size()
    return (d % n == 0 and d <= MAX_VECTORS_PER_THREAD * VECTOR_THREADS * n
            and not (x.data_ptr() % 16 or out.data_ptr() % 16
                     or scale.data_ptr() % 16))


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
    vector = takes_vector_kernel(x2, scale, out)
    dev = x.get_device()
    per_block = -(-rows // (BLOCKS_PER_SM * _build.sm_count(dev)))
    err = _build.load_library().repro_rmsnorm(
        x2.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
        -(-rows // per_block), float(eps), DTYPE_CODES[x.dtype],
        DTYPE_CODES[scale.dtype], int(vector),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    if vector:
        rmsnorm.launches_vector += 1
    return out


rmsnorm.launches = 0
rmsnorm.launches_vector = 0
