"""The products a reference runs through, in the precision it is asked
for.

``"fp32"``: float32 products (TF32 is switched off around the whole
reference by :func:`strict_fp32`). ``"fp8"``: the control, the same
reference computed in the precision below the configuration's bf16,
as fp8 training does it: every product's inputs are rounded to
float8 e4m3 with one scale per tensor (its largest magnitude to 448),
each gradient that enters a backward product to e5m2 (to 57344), and
the products accumulate in float32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
_MAX = {E4M3: 448.0, E5M2: 57344.0}


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for matmuls and cuDNN inside, restored after."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def quantize(x: torch.Tensor, fmt) -> torch.Tensor:
    """``x`` rounded to ``fmt`` with one scale for the tensor, back in
    float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, _MAX[fmt] / amax, torch.ones_like(amax))
    return (x.float() * scale).to(fmt).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with ``a`` (..., m, k) and ``b`` (k, n) or (..., k, n)."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = quantize(a, E4M3), quantize(b, E4M3)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = quantize(g, E5M2)
        da = gq @ bq.transpose(-1, -2)
        if bq.ndim == 2:
            db = (aq.reshape(-1, aq.shape[-1]).T
                  @ gq.reshape(-1, gq.shape[-1]))
        else:
            db = aq.transpose(-1, -2) @ gq
        return da, db


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        xq, wq = quantize(x, E4M3), quantize(w, E4M3)
        ctx.save_for_backward(xq, wq)
        ctx.stride = stride
        return F.conv2d(xq, wq, stride=stride)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = quantize(g, E5M2)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, ctx.stride)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, ctx.stride)
        return dx, dw, None


class Precision:
    """``mm(a, b)`` and ``conv(x, w, stride)`` (padded input, OIHW
    kernel) in ``name``: ``"fp32"`` or ``"fp8"``."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def mm(self, a, b):
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b

    def conv(self, x, w, stride: int):
        if self.name == "fp8":
            return _Fp8Conv.apply(x, w, stride)
        return F.conv2d(x, w, stride=stride)
