"""Paged attention kernels: the port's plain versions against the
reference's oracles and its Pallas kernels.

On the CPU, ``repro_torch.kernels.ref`` must match ``repro.kernels.ref``
and the Pallas kernels run with ``interpret=True`` to <= 1e-3 (the
reference's own kernel gate) over block sizes {8, 16}, GQA groups
{1, 2, 3}, ragged lengths, shuffled block tables, prefix depths {1, 3}
and windows {None, 24}; the CUDA wrappers refuse CPU tensors. The
kernels themselves are checked on the card by ``test_torch_cuda.py``.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import (
    paged_decode_attention as pallas_decode,
)
from repro.kernels.prefill_attention import (
    paged_prefill_attention as pallas_prefill,
)
from repro_torch.kernels import ops

torch.set_num_threads(1)

# one compiled program per case instead of op-by-op dispatch
_jit = functools.partial(jax.jit, static_argnames=("window",))
jref_decode = _jit(jref.paged_decode_attention_ref)
jref_prefill = _jit(jref.paged_prefill_attention_ref)
pallas_decode = _jit(functools.partial(pallas_decode, interpret=True))
pallas_prefill = _jit(functools.partial(pallas_prefill, interpret=True))

KH, DH, B = 2, 16, 3
TOL = dict(rtol=1e-3, atol=1e-3)
DECODE = list(itertools.product([8, 16], [1, 2, 3], [None, 24]))
PREFILL = list(itertools.product([8, 16], [1, 2, 3], [1, 3], [None, 24]))


def _pool(rng, bs, n_blocks, kh=KH, dh=DH):
    return (rng.normal(size=(n_blocks, bs, kh, dh)).astype(np.float32),
            rng.normal(size=(n_blocks, bs, kh, dh)).astype(np.float32))


def _tables(rng, b, nb, n_blocks):
    """Shuffled physical ids (alloc/free order) drawn from 1..n_blocks-1."""
    ids = rng.permutation(np.arange(1, n_blocks))[:b * nb]
    return ids.reshape(b, nb).astype(np.int32)


def _decode_inputs(bs, g, seed, max_len=64, kh=KH, dh=DH, b=B):
    rng = np.random.default_rng(seed)
    nb = max_len // bs
    n_blocks = 1 + b * nb
    k_pool, v_pool = _pool(rng, bs, n_blocks, kh, dh)
    tables = _tables(rng, b, nb, n_blocks)
    lengths = rng.integers(1, max_len + 1, size=b).astype(np.int32)
    lengths[0] = 1                                  # a lone first token
    tables[0, 1:] = 0                               # unowned -> trash block
    q = rng.normal(size=(b, kh * g, dh)).astype(np.float32)
    return q, k_pool, v_pool, tables, lengths


def _prefill_inputs(bs, g, npre, seed, sq=24, kh=KH, dh=DH, b=B):
    rng = np.random.default_rng(seed)
    n_blocks = 2 + b * npre
    k_pool, v_pool = _pool(rng, bs, n_blocks, kh, dh)
    tables = _tables(rng, b, npre, n_blocks)
    q = rng.normal(size=(b, sq, kh * g, dh)).astype(np.float32)
    k_suf = rng.normal(size=(b, sq, kh, dh)).astype(np.float32)
    v_suf = rng.normal(size=(b, sq, kh, dh)).astype(np.float32)
    return q, k_suf, v_suf, k_pool, v_pool, tables


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("bs,g,window", DECODE)
def test_decode_plain_matches_reference_and_pallas(bs, g, window):
    arrays = _decode_inputs(bs, g, seed=bs * 10 + g)
    got = ops.paged_decode_attention(*_t(arrays), window=window).numpy()
    want = jref_decode(*_j(arrays), window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = pallas_decode(*_j(arrays), window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("bs,g,npre,window", PREFILL)
def test_prefill_plain_matches_reference_and_pallas(bs, g, npre, window):
    arrays = _prefill_inputs(bs, g, npre, seed=bs * 100 + g * 10 + npre)
    got = ops.paged_prefill_attention(*_t(arrays), window=window).numpy()
    want = jref_prefill(*_j(arrays), window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = pallas_prefill(*_j(arrays), window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.prefill_attention import paged_prefill_attention
    with pytest.raises(ValueError, match="CUDA kernel"):
        paged_decode_attention(*_t(_decode_inputs(8, 1, seed=3)))
    with pytest.raises(ValueError, match="CUDA kernel"):
        paged_prefill_attention(*_t(_prefill_inputs(8, 1, 1, seed=4)))
