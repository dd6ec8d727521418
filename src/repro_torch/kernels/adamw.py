"""Multi-tensor AdamW on the card: wrapper of ``csrc/adamw.cu``.

Replaces no TPU kernel: the reference's AdamW is plain array code (XLA
fuses it). It replaces the port's per-leaf loop on the card, whose
~21 small launches a leaf the host paced (the source file's note gives
the bound and the design). The plain version is
``train.optimizer.adamw_leaves_ref``, the CPU path. ``adamw.launches``
counts the kernel launches: the norm, the finalize and the update, so
three a call for a tree whose leaves fit one table.

:func:`plan` cuts leaves into work items from their element counts
alone; the plan is cached by them, while the pointers of every tensor
are read on each call (the gradients are new every step).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES

#: elements of one work item (``kChunk`` in the source)
CHUNK = 1 << 14
#: leaves one launch's table holds, per pass (``kMaxNormLeaves``,
#: ``kMaxUpdateLeaves``)
MAX_NORM_LEAVES = 1000
MAX_UPDATE_LEAVES = 560
#: items one launch holds (a grid's x dimension)
MAX_ITEMS = (1 << 31) - 1
#: leaf flags (``csrc/adamw.cu``)
PARAM_BF16, DECAY, VECTOR = 1, 2, 4
BF16 = DTYPE_CODES[torch.bfloat16]
#: the source's ``NormLeaf`` and ``UpdateLeaf``, field for field
NORM_LEAF = np.dtype({"names": ["g", "numel", "first", "flags", "div"],
                      "formats": ["<u8", "<i8", "<i4", "<i4", "<f8"],
                      "offsets": [0, 8, 16, 20, 24], "itemsize": 32})
UPDATE_LEAF = np.dtype({
    "names": ["g", "m", "v", "master", "p", "numel", "first", "flags"],
    "formats": ["<u8"] * 5 + ["<i8", "<i4", "<i4"],
    "offsets": [0, 8, 16, 24, 32, 40, 48, 52], "itemsize": 56})


@dataclass(frozen=True)
class Group:
    """One launch of a pass: the call's leaves ``leaves`` (indices), the
    first item of each, and the launch's item count (its grid)."""
    leaves: tuple
    first: tuple
    items: int


def plan(numels: Sequence[int], max_leaves: int,
         chunk: int = CHUNK) -> tuple:
    """The launches of one pass over leaves of ``numels`` elements: each
    leaf with elements is cut into items of ``chunk`` elements (its last
    item the rest), numbered consecutively from the leaf's first; a
    launch takes at most ``max_leaves`` leaves and ``MAX_ITEMS`` items.
    Leaves with no element take no item and no launch."""
    groups, leaves, first, items = [], [], [], 0
    for i, n in enumerate(numels):
        k = -(-n // chunk)
        if k == 0:
            continue
        if k > MAX_ITEMS:
            raise ValueError(f"leaf {i} of {n} elements needs {k} items, "
                             f"over one launch's {MAX_ITEMS}")
        if len(leaves) == max_leaves or items + k > MAX_ITEMS:
            groups.append(Group(tuple(leaves), tuple(first), items))
            leaves, first, items = [], [], 0
        leaves.append(i)
        first.append(items)
        items += k
    if leaves:
        groups.append(Group(tuple(leaves), tuple(first), items))
    return tuple(groups)


@dataclass(frozen=True)
class _Pass:
    groups: tuple
    index: tuple        # per group: its leaves as an index array
    tables: tuple       # per group: the table with numel and first set
    items: int


@functools.lru_cache(maxsize=64)
def _pass(numels: tuple, max_leaves: int, dtype: np.dtype) -> _Pass:
    groups = plan(numels, max_leaves)
    index, tables = [], []
    for grp in groups:
        idx = np.asarray(grp.leaves, dtype=np.intp)
        tab = np.zeros(len(idx), dtype=dtype)
        tab["numel"] = np.asarray(numels, dtype=np.int64)[idx]
        tab["first"] = grp.first
        index.append(idx)
        tables.append(tab)
    return _Pass(groups, tuple(index), tuple(tables),
                 sum(g.items for g in groups))


@functools.lru_cache(maxsize=None)
def _library():
    """The library, once its chunk and table layout are checked against
    this module's."""
    lib = _build.load_library()
    got = (ctypes.c_longlong * 5)()
    lib.repro_adamw_layout(got)
    want = (CHUNK, MAX_NORM_LEAVES, MAX_UPDATE_LEAVES, NORM_LEAF.itemsize,
            UPDATE_LEAF.itemsize)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/adamw.cu layout {tuple(got)} != the "
                           f"wrapper's {want}")
    return lib


def _pointers(ts) -> np.ndarray:
    return np.fromiter((t.data_ptr() for t in ts), np.uint64, len(ts))


def _codes(ts, what: str) -> np.ndarray:
    try:
        return np.fromiter((DTYPE_CODES[t.dtype] for t in ts), np.int32,
                           len(ts))
    except KeyError:
        bad = sorted({str(t.dtype) for t in ts
                      if t.dtype not in DTYPE_CODES})
        raise TypeError(f"{what} must be {sorted(map(str, DTYPE_CODES))}, "
                        f"got {bad}") from None


def adamw(norm_grads: Sequence[torch.Tensor], grads, m, v, master, params,
          *, lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
          b1: float, b2: float, eps: float, weight_decay: float,
          clip: float, norm_divisors: Optional[Sequence[int]] = None,
          reduce: Optional[Callable] = None) -> torch.Tensor:
    """One AdamW step over every leaf, in place, on the card.

    ``norm_grads`` are the tensors whose squares make the clip's global
    norm (each leaf's divided by its entry of ``norm_divisors``, and the
    sum passed through ``reduce``, a sum over ranks, when given);
    ``grads``, ``m``, ``v``, ``master`` and ``params`` are the update's
    leaves, as many elements leaf by leaf: fp32 gradients, moments and
    master weights, fp32 or bf16 params; the moments, master weights
    and params must be contiguous (they are written in place).
    Decoupled weight decay applies to leaves with ``master.ndim >= 1``.
    ``lr``, ``bc1`` and ``bc2`` are fp32 scalars on the card (the step's
    learning rate and bias corrections). Returns the global norm, a 0-d
    fp32 tensor on the card; nothing synchronises with the host."""
    n = len(grads)
    leaves = (grads, m, v, master, params)
    if any(len(x) != n for x in leaves):
        raise ValueError(f"leaf lists of lengths {[len(x) for x in leaves]}")
    if norm_divisors is not None and len(norm_divisors) != len(norm_grads):
        raise ValueError("one divisor per norm gradient")
    dev = lr.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {dev}")
    same = norm_grads is grads       # the norm over the update's gradients
    lists = leaves if same else (norm_grads, *leaves)
    if any(t.get_device() != dev.index for x in (*lists, (lr, bc1, bc2))
           for t in x):
        bad = sorted({str(t.device) for x in lists for t in x})
        raise ValueError(f"tensors on {bad}: the kernel takes one card")
    for t in (lr, bc1, bc2):
        if t.dtype != torch.float32 or t.numel() != 1:
            raise TypeError(f"lr, bc1, bc2 must be one fp32 element, got "
                            f"{t.dtype} {tuple(t.shape)}")
    for what, ts in (("gradients", grads), ("norm gradients", norm_grads),
                     ("m", m), ("v", v), ("master", master)):
        if any(t.dtype != torch.float32 for t in ts):
            raise TypeError(f"{what} must be float32")
    if not all(t.is_contiguous() for x in leaves[1:] for t in x):
        raise ValueError("m, v, master and params must be contiguous: the "
                         "kernel writes them in place")
    counts = np.array([[t.numel() for t in x] for x in leaves],
                      dtype=np.int64).reshape(5, n)
    bad = np.flatnonzero((counts != counts[0]).any(0))
    if bad.size:
        raise ValueError(f"leaf {bad[0]}: shapes "
                         f"{[tuple(x[bad[0]].shape) for x in leaves]}")
    param_bf16 = _codes(params, "params") == BF16
    grads = [g.contiguous() for g in grads]
    norm_grads = grads if same else [g.contiguous() for g in norm_grads]
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = {k: _pointers(ts) for k, ts in zip(
        ("g", "m", "v", "master", "p"), (grads, m, v, master, params))}

    # the norm: one partial per item of every launch
    npass = _pass(tuple(counts[0].tolist()) if same else
                  tuple(g.numel() for g in norm_grads), MAX_NORM_LEAVES,
                  NORM_LEAF)
    gptr = ptrs["g"] if same else _pointers(norm_grads)
    flags = np.where(gptr % 16 == 0, VECTOR, 0)
    div = np.ones(len(norm_grads)) if norm_divisors is None \
        else np.asarray(norm_divisors, dtype=np.float64)
    partials = torch.empty(npass.items, dtype=torch.float64, device=dev)
    at = partials.data_ptr()
    for grp, idx, tab in zip(npass.groups, npass.index, npass.tables):
        tab = tab.copy()
        tab["g"], tab["flags"], tab["div"] = gptr[idx], flags[idx], div[idx]
        _build.check(lib.repro_adamw_norm(tab.ctypes.data, len(idx),
                                          grp.items, at, stream),
                     "adamw norm")
        adamw.launches += 1
        at += grp.items * partials.element_size()
    if reduce is not None:
        partials = reduce(partials.sum().reshape(1))
    stats = torch.empty(2, dtype=torch.float32, device=dev)
    _build.check(lib.repro_adamw_finalize(partials.data_ptr(),
                                          partials.numel(), clip,
                                          stats.data_ptr(), stream),
                 "adamw finalize")
    adamw.launches += 1

    # the update
    upass = _pass(tuple(counts[0].tolist()), MAX_UPDATE_LEAVES, UPDATE_LEAF)
    aligned = functools.reduce(np.bitwise_or, ptrs.values()) % 16 == 0
    flags = (np.where(param_bf16, PARAM_BF16, 0)
             | np.fromiter((DECAY if w.ndim >= 1 else 0 for w in master),
                           np.int32, n)
             | np.where(aligned, VECTOR, 0))
    args = (stats.data_ptr(), lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
            b1, b2, 1 - b1, 1 - b2, eps, weight_decay, stream)
    for grp, idx, tab in zip(upass.groups, upass.index, upass.tables):
        tab = tab.copy()
        for k, p in ptrs.items():
            tab[k] = p[idx]
        tab["flags"] = flags[idx]
        _build.check(lib.repro_adamw_update(tab.ctypes.data, len(idx),
                                            grp.items, *args),
                     "adamw update")
        adamw.launches += 1
    return stats[0]


adamw.launches = 0

