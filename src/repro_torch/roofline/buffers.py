"""The largest tensors a program makes (debug and perf tool).

Port of ``src/repro/roofline/buffers.py``, which reads the shapes out of
a compiled HLO module's text. A PyTorch program has no such text, so
:class:`ShapeTrace`, a dispatch mode, records the shape and dtype of
every op's output while the program runs (on ``meta`` tensors it runs
without memory), and :func:`largest_shapes` returns the reference's
``(bytes, count, shape_str)`` rows, with shapes spelled as HLO spells
them (``bf16[16,4096,512]``). A row's count is the number of op outputs
of that shape, where the reference counts the shape's mentions in the
HLO text.
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_HLO_DTYPE = {
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.bool: "pred",
}


def shape_str(t: torch.Tensor) -> str:
    dt = _HLO_DTYPE.get(t.dtype, str(t.dtype).removeprefix("torch."))
    return f"{dt}[{','.join(str(d) for d in t.shape)}]"


class ShapeTrace(TorchDispatchMode):
    """Counts every op output by shape and dtype while it is active."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()
        self.sizes: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                key = shape_str(t)
                self.counts[key] += 1
                self.sizes[key] = t.numel() * t.element_size()
        return out


def largest_shapes(trace: ShapeTrace,
                   top: int = 20) -> list[tuple[float, int, str]]:
    """Returns [(bytes, count, shape_str)] sorted by bytes desc."""
    out = [(float(trace.sizes[k]), trace.counts[k], k) for k in trace.sizes]
    out.sort(reverse=True)
    return out[:top]
