"""Flash attention, RMSNorm and the int8 paged-prefill path: the port's
plain versions against the reference's oracles and its Pallas kernels.

On the CPU, ``repro_torch.kernels.ref`` must match ``repro.kernels.ref``
over the reference's own sweeps (``tests/test_kernels.py``, and prefill
block sizes {8, 16} x GQA groups {1, 3} x prefix depths {1, 3} x windows
{None, 24} on int8 pools with identical codes and scales), and the
Pallas kernels run with ``interpret=True`` on a few cases of each. The
tolerance is the reference's: <= 1e-3 in fp32 (its kernel gate), and in
bf16 its ``_tol`` (2e-2). ``kernels.ops`` on CPU tensors is the plain
version and counts no launch; the CUDA wrappers refuse CPU tensors. The
kernels themselves are checked on the card by ``test_torch_cuda.py``.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.bench.workloads.kernels import quantize
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.prefill_attention import paged_prefill_attention
from repro_torch.kernels.rmsnorm import rmsnorm

torch.set_num_threads(1)

FP32_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}

FLASH_SWEEP = [
    # b, sq, skv, h, kh, dh, causal, window, dtype (tests/test_kernels.py)
    (1, 128, 128, 1, 1, 64, True, None, "f32"),
    (2, 256, 256, 4, 2, 64, True, None, "f32"),
    (1, 256, 256, 8, 8, 128, True, None, "bf16"),
    (2, 128, 256, 4, 4, 64, True, None, "f32"),      # suffix queries
    (1, 256, 256, 6, 2, 64, True, 128, "f32"),       # windowed
    (1, 512, 512, 2, 1, 128, True, 256, "bf16"),     # windowed bf16
    (2, 256, 256, 4, 2, 64, False, None, "f32"),     # bidirectional
    (1, 384, 384, 3, 3, 64, True, None, "f32"),      # odd heads
]
FLASH_PALLAS = [FLASH_SWEEP[i] for i in (3, 4, 6)]
RMSNORM_SWEEP = [(8, 64, "f32"), (37, 512, "bf16"), (300, 128, "f32"),
                 (1, 1024, "bf16")]
RMSNORM_PALLAS = [RMSNORM_SWEEP[i] for i in (1, 2)]
KH, DH, B = 2, 16, 3
INT8_PREFILL = [(bs, g, npre, window, "f32") for bs, g, npre, window in
                itertools.product([8, 16], [1, 3], [1, 3], [None, 24])] + [
    (16, 3, 3, None, "bf16"), (8, 2, 1, 24, "bf16")]
INT8_PALLAS = [(16, 3, 3, None, "f32"), (8, 2, 1, 24, "f32")]

_jit_prefill = functools.partial(jax.jit, static_argnames=("window",))
jref_prefill = _jit_prefill(jref.paged_prefill_attention_ref)
pallas_prefill = _jit_prefill(functools.partial(
    jops.paged_prefill_attention, impl="pallas", interpret=True))


def _tol(dt):
    return BF16_TOL if dt == "bf16" else FP32_TOL


def _t(a, dt="f32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TORCH[dt]) \
        if a.dtype == np.float32 else torch.from_numpy(a.copy())


def _j(a, dt="f32"):
    return jnp.asarray(a).astype(JAX[dt]) if a.dtype == np.float32 \
        else jnp.asarray(a)


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      x.astype(jnp.float32), np.float32)


def _flash_arrays(b, sq, skv, h, kh, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, dh)).astype(np.float32),
            rng.normal(size=(b, skv, kh, dh)).astype(np.float32),
            rng.normal(size=(b, skv, kh, dh)).astype(np.float32))


@pytest.mark.parametrize("b,sq,skv,h,kh,dh,causal,window,dt", FLASH_SWEEP)
def test_flash_plain_matches_reference(b, sq, skv, h, kh, dh, causal,
                                       window, dt):
    arrays = _flash_arrays(b, sq, skv, h, kh, dh)
    got = ops.flash_attention(*(_t(a, dt) for a in arrays), causal=causal,
                              window=window)
    want = jref.flash_attention_ref(*(_j(a, dt) for a in arrays),
                                    causal=causal, window=window)
    assert got.dtype == TORCH[dt] and got.shape == (b, sq, h, dh)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("b,sq,skv,h,kh,dh,causal,window,dt", FLASH_PALLAS)
def test_flash_plain_matches_pallas_interpret(b, sq, skv, h, kh, dh, causal,
                                              window, dt):
    arrays = _flash_arrays(b, sq, skv, h, kh, dh, seed=1)
    got = ref.flash_attention_ref(*(_t(a, dt) for a in arrays),
                                  causal=causal, window=window)
    want = jops.flash_attention(*(_j(a, dt) for a in arrays), causal=causal,
                                window=window, impl="pallas", interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


def _rms_arrays(rows, d):
    rng = np.random.default_rng(rows + d)
    return ((rng.normal(size=(rows, d)) * 3).astype(np.float32),
            rng.normal(size=(d,)).astype(np.float32))


@pytest.mark.parametrize("rows,d,dt", RMSNORM_SWEEP)
def test_rmsnorm_plain_matches_reference(rows, d, dt):
    x, s = _rms_arrays(rows, d)
    got = ops.rmsnorm(_t(x, dt), _t(s))
    want = jref.rmsnorm_ref(_j(x, dt), _j(s))
    assert got.dtype == TORCH[dt]
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("rows,d,dt", RMSNORM_PALLAS)
def test_rmsnorm_plain_matches_pallas_interpret(rows, d, dt):
    x, s = _rms_arrays(rows, d)
    got = ref.rmsnorm_ref(_t(x, dt), _t(s))
    want = jops.rmsnorm(_j(x, dt), _j(s), impl="pallas", interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


def _int8_prefill_arrays(bs, g, npre, seed, sq=24):
    """q, suffix K/V, int8 pool codes, their (n_blocks, Kh) scales and
    shuffled tables whose last row is a pad row on the trash block 0."""
    rng = np.random.default_rng(seed)
    n_blocks = 2 + B * npre
    tables = rng.permutation(np.arange(1, n_blocks))[:B * npre]
    tables = tables.reshape(B, npre).astype(np.int32)
    tables[-1] = 0
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    codes = lambda: rng.integers(-127, 128, size=(n_blocks, bs, KH, DH)
                                 ).astype(np.int8)
    scale = lambda: rng.uniform(0.001, 0.05, size=(n_blocks, KH)).astype(
        np.float32)
    return (f(B, sq, KH * g, DH), f(B, sq, KH, DH), f(B, sq, KH, DH),
            codes(), codes(), tables), (scale(), scale())


@pytest.mark.parametrize("bs,g,npre,window,dt", INT8_PREFILL)
def test_int8_prefill_plain_matches_reference(bs, g, npre, window, dt):
    arrays, (ksc, vsc) = _int8_prefill_arrays(bs, g, npre,
                                              seed=bs * 100 + g * 10 + npre)
    got = ops.paged_prefill_attention(
        *(_t(a, dt) for a in arrays), window=window, k_scale=_t(ksc),
        v_scale=_t(vsc))
    want = jref_prefill(*(_j(a, dt) for a in arrays), window=window,
                        k_scale=_j(ksc), v_scale=_j(vsc))
    assert got.dtype == TORCH[dt]
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("bs,g,npre,window,dt", INT8_PALLAS)
def test_int8_prefill_plain_matches_pallas_interpret(bs, g, npre, window,
                                                     dt):
    arrays, (ksc, vsc) = _int8_prefill_arrays(bs, g, npre, seed=5)
    got = ref.paged_prefill_attention_ref(
        *(_t(a, dt) for a in arrays), window=window, k_scale=_t(ksc),
        v_scale=_t(vsc))
    want = pallas_prefill(*(_j(a, dt) for a in arrays), window=window,
                          k_scale=_j(ksc), v_scale=_j(vsc))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


def test_dequantize_pool_scales_match_reference():
    (*_, k_codes, _v, tables), (ksc, _) = _int8_prefill_arrays(8, 1, 3, 9)
    got = ref.dequantize_pool(_t(k_codes), _t(tables), _t(ksc))
    want = jref.dequantize_pool(_j(k_codes), _j(tables), _j(ksc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_quantize_matches_reference_quantiser():
    """The workload's int8 quantiser is the reference's
    (``bench/workloads/kernels.py:57-61``)."""
    pool = np.random.default_rng(2).normal(size=(5, 16, 2, 16)).astype(
        np.float32)
    pool[3, :, 1] = 0.0                     # an all-zero (block, head)
    jp = jnp.asarray(pool)
    sc = jnp.max(jnp.abs(jp), axis=(1, 3)) / 127.0
    sc = jnp.where(sc > 0, sc, 1.0)
    want = jnp.clip(jnp.round(jp / sc[:, None, :, None]), -127, 127).astype(
        jnp.int8)
    codes, scale = quantize(torch.from_numpy(pool))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    np.testing.assert_allclose(scale.numpy(), np.asarray(sc), rtol=1e-7)


def test_ops_on_cpu_are_the_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    q, k, v = (_t(a) for a in _flash_arrays(1, 64, 96, 4, 2, 64))
    torch.testing.assert_close(ops.flash_attention(q, k, v, window=40),
                               ref.flash_attention_ref(q, k, v, window=40),
                               rtol=0, atol=0)
    x, s = (_t(a) for a in _rms_arrays(9, 64))
    torch.testing.assert_close(ops.rmsnorm(x, s, eps=1e-6),
                               ref.rmsnorm_ref(x, s, eps=1e-6),
                               rtol=0, atol=0)
    arrays, (ksc, vsc) = _int8_prefill_arrays(8, 2, 1, seed=3)
    args = [_t(a) for a in arrays]
    torch.testing.assert_close(
        ops.paged_prefill_attention(*args, k_scale=_t(ksc),
                                    v_scale=_t(vsc)),
        ref.paged_prefill_attention_ref(*args, k_scale=_t(ksc),
                                        v_scale=_t(vsc)), rtol=0, atol=0)
    assert set(ops.launch_counts().values()) == {0}
    assert paged_prefill_attention.launches_int8 == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = (_t(a) for a in _flash_arrays(1, 64, 64, 2, 1, 64))
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA kernel"):
        rmsnorm(*(_t(a) for a in _rms_arrays(4, 64)))
    arrays, (ksc, vsc) = _int8_prefill_arrays(8, 1, 1, seed=4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        paged_prefill_attention(*(_t(a) for a in arrays), k_scale=_t(ksc),
                                v_scale=_t(vsc))
