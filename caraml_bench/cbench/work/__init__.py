"""The matrix-product work of one training step, from the shapes.

Each model kind's module gives ``step_ops(cfg, traffic)``: a list of
:class:`Op`, each a product that the step needs, with its operations
(2 a multiply-add) and its least bytes (each operand read once, each
output written once, bf16). Recomputation is not counted: a product is
counted once forward and, for each input that needs a gradient, once
backward. :func:`least_seconds` is the time the chip could take for
them at its published peaks.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Op:
    name: str
    flops: float
    bytes: float
    count: int = 1


def matmul(name: str, m: int, k: int, n: int, *, count: int = 1,
           passes: int = 3, width: int = 2) -> Op:
    """``passes`` products of an ``(m, k) x (k, n)`` shape: forward,
    input gradient, weight gradient; every pass reads two of the three
    matrices and writes the third."""
    return Op(name, passes * 2.0 * m * k * n,
              passes * width * (m * k + k * n + m * n), count)


def total_flops(ops) -> float:
    return sum(o.flops * o.count for o in ops)


def least_seconds(ops, peak_flops: float, bytes_per_s: float) -> float:
    """Sum over the products of the larger of their operations over the
    peak and their bytes over the memory bandwidth."""
    return sum(o.count * max(o.flops / peak_flops, o.bytes / bytes_per_s)
               for o in ops)
