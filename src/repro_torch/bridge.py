"""Bridge from the reference's parameter trees to the port's tensors.

The reference (``src/repro/models/lm.py::init``) builds a nested dict of
arrays with layer-stacked leaves (``blocks.stack_init``). Handed over as
numpy arrays, :func:`params_from_numpy` turns that tree into torch
tensors of the same shapes, layouts and dtypes, so both packages can run
on the same weights. bf16 leaves arrive as numpy's ``bfloat16`` extension
dtype, which ``torch.from_numpy`` rejects: they cross as their uint16
bit pattern and are viewed back as ``torch.bfloat16``.
:func:`train_state_from_numpy` carries a whole train state across the
same way: the reference's ``(params, opt_state)`` (AdamW's or
Adafactor's, with its 0-d int32 ``step``) and, for its pure-dp step, the
gradient-sync error state.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """One leaf, bit-exact (bf16 via its uint16 view), in its own
    writable memory."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(a, order="C").view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays -> same nested dict of tensors on
    ``device`` (``dtype`` casts floating leaves when given)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    t = tensor_from_numpy(tree)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(dev)


def train_state_from_numpy(params: Any, opt_state: Any,
                           sync_state: Optional[np.ndarray] = None,
                           device: DeviceLike = None):
    """The reference's train state as numpy trees -> ``(params,
    opt_state)`` of tensors on ``device``, leaf for leaf (``step`` stays
    a 0-d int32 tensor); with ``sync_state`` (the reference's
    ``(n_devices, n_buckets, bucket_elems)`` error-feedback residual of
    a one-device mesh) also that, as the third element."""
    out = (params_from_numpy(params, device),
           params_from_numpy(opt_state, device))
    if sync_state is None:
        return out
    return out + (params_from_numpy(sync_state, device),)
