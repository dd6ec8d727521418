"""The port's CUDA kernels on the card, against their plain versions.

Paged decode and paged prefill (fp and int8 pools) over block sizes,
GQA groups, prefix depths and windows, the decode also at B = 1 (one
sequence over many splits) and B = 64 (few splits), at head widths 16
and 96 and at GQA groups of 4, 7 and 8 (several head chunks per KV
head), on split boundaries, with a window that hides whole splits,
giving equal bits on two calls, on two streams at once and in a CUDA
graph, the prefill in bf16 also at the
configs' head widths (16, 64, 96, 128), with ragged packed-row tiles and
with a window that hides whole prefix tiles; flash attention over the
reference's SWEEP (``tests/test_kernels.py``) in both types, one-query
and ragged cases, strided inputs and the llama3.2-3b prefill width; the
bf16 (tensor-core) kernels refusing unaligned views, head widths
without an instance and block sizes that are not a multiple of 8; RMSNorm over the reference's
sweep, D not whole 16-byte vectors (100, 3073, the scalar kernel), D =
8192, an offset unaligned view, mixed scale types, leading dims and the
(4096, 3072) width; and
no fallback: a kernel missing from the library, or a type a kernel does
not take, raises. The serve engine on the card (kernels) against the CPU
(plain versions): fp and int8 pools, phased and chunked with
preemption, and the slotted cache (no kernel: ``sdpa`` over dense rows,
op by op and in the engine). NVML's energy counter against the
trapezoid of NVML's power reading over a steady matmul load, and the
counter's update interval (both printed: run with ``-s``). Training on
the card: three AdamW steps of a reduced fp32 gpt-800m against the CPU
from the same weights, a checkpoint round trip of card tensors (the
async snapshot taken before an in-place update), and two identical
5-step runs of full-width gpt-117m giving element-equal loss traces and
params (the ops torch's deterministic mode would flag are printed).
ResNet on the card: five full-width bf16 ResNet50 steps with a finite,
falling loss; three AdamW steps of a reduced fp32 ResNet against the CPU
(TF32 off); a checkpoint round trip of a ResNet train state (its
list-shaped ``stages`` keys). The moe, ssm and hybrid families: the
paged decode at granite-moe's and jamba's head shapes (fp and int8
pools), the reduced families' engines (paged and slotted) on the card
against the CPU with the decode kernel's launches counted per attention
layer, and three AdamW steps of the reduced moe, ssm and hybrid configs
on the card against the CPU. Fixed-batch ``generate`` of reduced
whisper-small and llava-next-34b and their three AdamW steps on the card
against the CPU, the q-chunked attention against full ``sdpa`` on the
card, and a slot-faulted chunked serve equal to its fault-free twin.
The harness: one ``heatmap`` dp1 cell through the bench CLI on NVML's
energy counter (full gpt-117m), ``make_data_iter``'s batches on the card
equal to the CPU's, ``FallbackPower`` over the NVML pair keeping its
column an energy counter while its primary fails, and RAPL probed. The
dry run: the grouped dense decode against the repeat one in bf16 at full
head shapes, the meta FLOP count of a reduced train step equal to the
card's (and its peak within 10 % of the estimate), and ``remat="dots"``'s
peak between ``"none"``'s and ``"full"``'s.

Every test here is marked ``cuda`` and skips where there is no card.
This file imports neither JAX nor ``repro``, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance, as in ``chip_smoke.py``: the plain version runs in fp32 on
the inputs upcast and its result is cast to the kernel's type, and
|kernel - plain| <= tol * (1 + |plain|), tol 2**-7 in bf16 (one bf16 ulp
of the output: the kernels compute in fp32 and round once) and 1e-3 in
fp32 (summation order); in bf16 at most 1 % of the outputs may differ
at all (a wrong conversion moves about half of them).
"""
import itertools
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bench.workloads.kernels import plain_fp32 as _plain_fp32
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.resnet50 import CONFIG as RESNET50
from repro_torch.core import tree
from repro_torch.kernels import _build, decode_attention, ops, ref
from repro_torch.kernels.decode_attention import decode_splits, \
    paged_decode_attention
from repro_torch.kernels.prefill_attention import paged_prefill_attention
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.models import attention, blocks, lm
from repro_torch.power.ctxmgr import get_power
from repro_torch.power.methods import NvmlEnergy, NvmlPower
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.requests import Request
from repro_torch.launch.train import make_data_fn, make_data_iter
from repro_torch.parallel import grad_sync as gs
from repro_torch.train.optimizer import OptConfig
from repro_torch.data.synthetic import synthetic_images
from repro_torch.train.step import (StepConfig, init_train_state,
                                    make_resnet_train_step, make_train_step)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  phase 9's card-vs-CPU family checks

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -7}
DTYPES = [torch.float32, torch.bfloat16]
#: block size, GQA group (1-3 fit one thread block; 4 and 8 take two and
#: three head chunks per KV head, the last one partial), window
DECODE = list(itertools.product([8, 16], [1, 2, 3, 4, 8], [None, 24]))
#: (batch, d_head) of the decode cases: B = 5 at llama3.2-3b's width, one
#: sequence (split over many blocks), 64 (B x Kh = 256 blocks, so few
#: splits), the reduced and the gpt-800m head widths
DECODE_SHAPES = [(5, 128), (1, 128), (64, 128), (5, 16), (5, 96)]
PREFILL = list(itertools.product([8, 16], [1, 2, 3], [1, 3], [None, 24]))
KH, DH = 4, 128
#: (dtype, d_head) of the prefill cases: fp32 (the FMA kernel) at 128,
#: bf16 (the tensor-core kernel) at the configs' head widths
PREFILL_TYPES = [(torch.float32, DH)] + [(torch.bfloat16, d)
                                         for d in (16, 64, 96, 128)]
FLASH_SWEEP = [
    # b, sq, skv, h, kh, dh, causal, window (tests/test_kernels.py:11-21)
    (1, 128, 128, 1, 1, 64, True, None),
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 256, 256, 8, 8, 128, True, None),
    (2, 128, 256, 4, 4, 64, True, None),      # suffix queries
    (1, 256, 256, 6, 2, 64, True, 128),       # windowed
    (1, 512, 512, 2, 1, 128, True, 256),
    (2, 256, 256, 4, 2, 64, False, None),     # bidirectional
    (1, 384, 384, 3, 3, 64, True, None),      # odd heads
    (1, 200, 333, 6, 2, 128, True, 100),      # ragged tiles
    (2, 1, 300, 6, 2, 128, True, None),       # one query
    (1, 1, 129, 3, 1, 64, False, None),       # one query, bidirectional
    (1, 100, 100, 4, 1, 64, True, 33),        # Sq % 64 != 0, G = 4
    (2, 2048, 2048, 24, 8, 128, True, None),  # llama3.2-3b prefill
]
#: the reference's sweep, (4096, 3072), D not whole 16-byte vectors (the
#: scalar kernel) and D = 8192, the top of the reference's stated range
RMSNORM_SWEEP = [(8, 64), (37, 512), (300, 128), (1, 1024), (4096, 3072),
                 (7, 100), (5, 3073), (16, 8192)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(card, dtype, *arrays):
    return [torch.from_numpy(a).to(card, dtype if a.dtype == np.float32
                                   else torch.int32) for a in arrays]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs,g,window", DECODE)
@pytest.mark.parametrize("b,dh", DECODE_SHAPES)
def test_decode_kernel_matches_plain(card, dtype, bs, g, window, b, dh):
    rng = np.random.default_rng(bs * 10 + g)
    nb = 256 // bs
    n_blocks = 1 + b * nb
    pool = lambda: rng.normal(size=(n_blocks, bs, KH, dh)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(b, nb)
    lengths = rng.integers(1, nb * bs + 1, size=b).astype(np.int32)
    if b > 1:
        lengths[0] = 1
        tables[0, 1:] = 0                           # unowned -> trash block
    q = rng.normal(size=(b, KH * g, dh)).astype(np.float32)
    args = _on(card, dtype, q, pool(), pool(), tables.astype(np.int32),
               lengths)
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == 1
    want = _plain_fp32(ref.paged_decode_attention_ref, *args, window=window)
    _assert_close(got, want, dtype)


def _int8_pools(card, rng, n_blocks, bs, dh=DH):
    """Two int8 code pools and their (n_blocks, Kh) fp32 scales."""
    pools, scales = [], []
    for _ in range(2):
        codes = rng.integers(-127, 128, size=(n_blocks, bs, KH, dh))
        pools.append(torch.from_numpy(codes.astype(np.int8)).to(card))
        scales.append(torch.from_numpy(rng.uniform(
            0.001, 0.05, size=(n_blocks, KH)).astype(np.float32)).to(card))
    return pools, scales


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs,g,window", DECODE)
@pytest.mark.parametrize("b,dh", DECODE_SHAPES)
def test_decode_kernel_int8_pool_matches_plain(card, dtype, bs, g, window, b,
                                               dh):
    """int8 pool codes and (n_blocks, Kh) scales, the same through both
    sides; row 0 reads only the trash block 0 past its one token."""
    rng = np.random.default_rng(bs * 10 + g + 7)
    nb = 256 // bs
    n_blocks = 1 + b * nb
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(b, nb)
    lengths = rng.integers(1, nb * bs + 1, size=b).astype(np.int32)
    if b > 1:
        lengths[0] = 1
        tables[0, 1:] = 0
    q, tab, lens = _on(card, dtype,
                       rng.normal(size=(b, KH * g, dh)).astype(np.float32),
                       tables.astype(np.int32), lengths)
    pools, scales = _int8_pools(card, rng, n_blocks, bs, dh)
    kw = dict(window=window, k_scale=scales[0], v_scale=scales[1])
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(q, *pools, tab, lens, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == 1
    assert paged_decode_attention.launches_int8 == 1
    want = _plain_fp32(ref.paged_decode_attention_ref, q, *pools, tab, lens,
                       **kw)
    _assert_close(got, want, dtype)


def _decode_forced(args, kw, *, window=None, splits=None):
    """The decode wrapper with its split count forced (its private entry;
    None keeps ``decode_splits``' choice)."""
    return decode_attention._paged_decode_attention(
        *args, window, kw.get("k_scale"), kw.get("v_scale"), splits)


def _decode_case(card, dtype, rng, lengths, *, nb, bs=16, g=3, int8):
    """Decode inputs whose tables own ceil(length / bs) blocks, the rest
    pointing at the trash block 0, and the int8 pools' scales."""
    b = len(lengths)
    n_blocks = 1 + b * nb
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((b, nb), np.int32)
    for i, n in enumerate(lengths):
        need = -(-n // bs)
        tables[i, :need] = perm[i * nb:i * nb + need]
    q, tab, lens = _on(card, dtype,
                       rng.normal(size=(b, KH * g, DH)).astype(np.float32),
                       tables, np.asarray(lengths, np.int32))
    if int8:
        pools, (ksc, vsc) = _int8_pools(card, rng, n_blocks, bs)
        return (q, *pools, tab, lens), dict(k_scale=ksc, v_scale=vsc)
    pools = _on(card, dtype, *(rng.normal(size=(n_blocks, bs, KH, DH))
                               .astype(np.float32) for _ in range(2)))
    return (q, *pools, tab, lens), {}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernel_split_boundaries_and_windows(card, dtype, int8):
    """Four splits of 4 blocks of 16 keys: lengths at and one past a split
    boundary, and windows that hide whole splits (of the longest rows)
    or all but the last key's split."""
    rng = np.random.default_rng(21 + int8)
    edge = 4 * 16
    args, kw = _decode_case(card, dtype, rng,
                            [edge, edge + 1, 2 * edge, 3 * edge + 1, 1,
                             4 * edge], nb=16, int8=int8)
    for window in (None, 20, edge, 100):
        for splits in (4, 3, 16):
            ops.reset_launch_counts()
            got = _decode_forced(args, kw, window=window, splits=splits)
            torch.cuda.synchronize()
            assert ops.launch_counts()["paged_decode_attention"] == 1
            want = _plain_fp32(ref.paged_decode_attention_ref, *args,
                               window=window, **kw)
            _assert_close(got, want, dtype)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernel_gives_equal_bits_on_two_calls(card, int8):
    """The splits combine in split order, with no float atomics: two
    calls on the same inputs give the same bits (the default split count
    at B = 8, and the most splits)."""
    rng = np.random.default_rng(33)
    args, kw = _decode_case(card, torch.bfloat16, rng,
                            rng.integers(1, 1025, size=8).tolist(), nb=64,
                            int8=int8)
    splits, _ = decode_splits(8, KH, 64, _build.sm_count(card.index or 0),
                              group=3)
    assert splits > 1
    for n in (None, 64):
        a = _decode_forced(args, kw, splits=n)
        b = _decode_forced(args, kw, splits=n)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernel_row_bits_do_not_depend_on_the_bucket(card, dtype,
                                                            int8):
    """Eight rows of at most 16 blocks through 16, 32 and 64 columns of
    their 64-column table (the engine's bucket follows its longest live
    slot): the split count changes with the bucket, each split's columns
    do not, so every row's output is equal bit for bit, and within the
    gate of the plain version."""
    rng = np.random.default_rng(34 + int8)
    args, kw = _decode_case(card, dtype, rng,
                            rng.integers(1, 16 * 16 + 1, size=8).tolist(),
                            nb=64, int8=int8)
    q, kp, vp, tab, lens = args
    outs = [ops.paged_decode_attention(q, kp, vp, tab[:, :nb], lens, **kw)
            for nb in (16, 32, 64)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    want = _plain_fp32(ref.paged_decode_attention_ref, *args, **kw)
    _assert_close(outs[0], want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("g", [4, 7, 8])
def test_decode_kernel_head_chunks_over_splits(card, dtype, int8, g):
    """A GQA group of more than 3 heads takes ceil(G / 3) blocks per KV
    head, the last one partial (G = 4: 3 + 1, 7: 3 + 3 + 1, 8: 3 + 3 +
    2), each with its own partials and ticket: lengths at and past split
    boundaries, windows that hide whole splits, several split counts."""
    rng = np.random.default_rng(50 + g + int8)
    edge = 4 * 16
    args, kw = _decode_case(card, dtype, rng,
                            [edge, edge + 1, 3 * edge + 1, 1, 4 * edge],
                            nb=16, g=g, int8=int8)
    for window in (None, 20, 100):
        for splits in (None, 1, 4, 3, 16):
            ops.reset_launch_counts()
            got = _decode_forced(args, kw, window=window, splits=splits)
            torch.cuda.synchronize()
            assert ops.launch_counts()["paged_decode_attention"] == 1
            want = _plain_fp32(ref.paged_decode_attention_ref, *args,
                               window=window, **kw)
            _assert_close(got, want, dtype)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernel_on_two_streams_and_in_a_graph(card, int8,
                                                     monkeypatch):
    """Each stream has its own partials and tickets: calls on two streams
    at once give the bits of the same calls on one stream. A graph
    captured on a stream after a call there replays to the same bits; a
    stream's first call inside a capture raises (its tickets would be
    zeroed inside the graph)."""
    monkeypatch.setattr(decode_attention, "_STATES", {})
    rng = np.random.default_rng(40 + int8)
    cases = [_decode_case(card, torch.bfloat16, rng,
                          rng.integers(513, 1025, size=2).tolist(), nb=64,
                          int8=int8) for _ in range(2)]
    want = [paged_decode_attention(*a, **k) for a, k in cases]
    streams = [torch.cuda.Stream() for _ in cases]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, ((a, k), s) in enumerate(zip(cases, streams)):
            with torch.cuda.stream(s):
                got[i].append(paged_decode_attention(*a, **k))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(x, want[i]) for x in got[i])
    a, k = cases[0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=streams[0]):
        out = paged_decode_attention(*a, **k)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want[0])
    fresh = torch.cuda.Stream()
    monkeypatch.setattr(decode_attention, "_STATES", {})
    with pytest.raises(RuntimeError, match="capturing"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            paged_decode_attention(*a, **k)
    torch.cuda.synchronize()


def test_decode_kernel_raises_on_widths_and_views_it_does_not_take(card):
    bf = dict(device=card, dtype=torch.bfloat16)
    tab = torch.tensor([[1]], dtype=torch.int32, device=card)
    lens = torch.tensor([3], dtype=torch.int32, device=card)
    q48, pool48 = torch.ones(1, KH, 48, **bf), torch.ones(2, 16, KH, 48, **bf)
    with pytest.raises(ValueError, match="d_head"):
        paged_decode_attention(q48, pool48, pool48, tab, lens)
    pool = torch.ones(2, 16, KH, DH, **bf)
    shifted = torch.ones(KH * DH + 1, **bf)[1:].view(1, KH, DH)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_attention(shifted, pool, pool, tab, lens)
    q = torch.ones(1, KH, DH, **bf)
    with pytest.raises(ValueError, match="splits"):
        _decode_forced((q, pool, pool, tab, lens), {}, splits=65)


def test_decode_kernel_int8_refuses_bad_scales(card):
    rng = np.random.default_rng(1)
    pools, (ksc, vsc) = _int8_pools(card, rng, 9, 16)
    q = torch.ones(2, KH, DH, device=card)
    tab = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=card)
    lens = torch.tensor([5, 20], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="both or neither"):
        paged_decode_attention(q, *pools, tab, lens, k_scale=ksc)
    with pytest.raises(TypeError, match="does not match q"):
        paged_decode_attention(q, *pools, tab, lens)    # codes, no scales
    with pytest.raises(TypeError, match="scales must be fp32"):
        paged_decode_attention(q, *pools, tab, lens, k_scale=ksc[:4],
                               v_scale=vsc[:4])
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(q, *pools, tab, lens, k_scale=ksc.t(),
                               v_scale=vsc.t())
    with pytest.raises(TypeError, match="scales must be fp32"):
        paged_decode_attention(q, *pools, tab, lens, k_scale=ksc.double(),
                               v_scale=vsc.double())
    with pytest.raises(TypeError, match="need int8"):
        paged_decode_attention(q, pools[0], pools[1].float(), tab, lens,
                               k_scale=ksc, v_scale=vsc)


@pytest.mark.parametrize("dtype,dh", PREFILL_TYPES)
@pytest.mark.parametrize("bs,g,npre,window", PREFILL)
def test_prefill_kernel_matches_plain(card, dtype, dh, bs, g, npre, window):
    rng = np.random.default_rng(bs * 100 + g * 10 + npre)
    b, sq = 3, 40                                   # ragged last tiles
    n_blocks = 2 + b * npre
    pool = lambda: rng.normal(size=(n_blocks, bs, KH, dh)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_blocks))[:b * npre]
    arrays = (rng.normal(size=(b, sq, KH * g, dh)).astype(np.float32),
              rng.normal(size=(b, sq, KH, dh)).astype(np.float32),
              rng.normal(size=(b, sq, KH, dh)).astype(np.float32),
              pool(), pool(), tables.reshape(b, npre).astype(np.int32))
    args = _on(card, dtype, *arrays)
    ops.reset_launch_counts()
    got = ops.paged_prefill_attention(*args, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_prefill_attention"] == 1
    want = _plain_fp32(ref.paged_prefill_attention_ref, *args,
                      window=window)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype,dh", PREFILL_TYPES)
@pytest.mark.parametrize("bs,g,npre,window", PREFILL)
def test_prefill_kernel_int8_pool_matches_plain(card, dtype, dh, bs, g, npre,
                                                window):
    """int8 pool codes and (n_blocks, Kh) scales, the same through both
    sides; the last row is a pad row on the trash block 0."""
    rng = np.random.default_rng(bs * 100 + g * 10 + npre + 7)
    b, sq = 3, 40
    n_blocks = 2 + b * npre
    tables = rng.permutation(np.arange(1, n_blocks))[:b * npre]
    tables = tables.reshape(b, npre).astype(np.int32)
    tables[-1] = 0
    arrays = (rng.normal(size=(b, sq, KH * g, dh)).astype(np.float32),
              rng.normal(size=(b, sq, KH, dh)).astype(np.float32),
              rng.normal(size=(b, sq, KH, dh)).astype(np.float32))
    q, ks, vs = _on(card, dtype, *arrays)
    pools, scales = _int8_pools(card, rng, n_blocks, bs, dh)
    tab = torch.from_numpy(tables).to(card)
    ops.reset_launch_counts()
    got = ops.paged_prefill_attention(q, ks, vs, *pools, tab, window=window,
                                      k_scale=scales[0], v_scale=scales[1])
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_prefill_attention"] == 1
    assert paged_prefill_attention.launches_int8 == 1
    want = _plain_fp32(ref.paged_prefill_attention_ref, q, ks, vs, *pools,
                       tab, window=window, k_scale=scales[0],
                       v_scale=scales[1])
    _assert_close(got, want, dtype)


def _prefill_case(card, dtype, rng, *, b, sq, g, npre, bs, int8):
    """Prefill inputs (q, k/v suffix, k/v pools, tables) and the pools'
    scales for an int8 case; the last row is a pad row on block 0."""
    n_blocks = 1 + b * npre
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(b, npre)
    tables[-1] = 0
    q, ks, vs = _on(card, dtype, *(rng.normal(size=(b, sq, KH * n, DH))
                                   .astype(np.float32) for n in (g, 1, 1)))
    if int8:
        pools, (ksc, vsc) = _int8_pools(card, rng, n_blocks, bs)
        kw = dict(k_scale=ksc, v_scale=vsc)
    else:
        pools = _on(card, dtype, *(rng.normal(size=(n_blocks, bs, KH, DH))
                                   .astype(np.float32) for _ in range(2)))
        kw = {}
    tab = torch.from_numpy(tables.astype(np.int32)).to(card)
    return (q, ks, vs, *pools, tab), kw


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True])
def test_prefill_kernel_ragged_row_tiles(card, dtype, int8):
    """Sq = 150 at G = 3 (450 packed rows: a 64-row tile cuts query
    positions between warps and tiles, the last holds 2 rows) behind
    npre = 5 blocks of 16 (a partial 64-key prefix tile)."""
    rng = np.random.default_rng(11 + int8)
    args, kw = _prefill_case(card, dtype, rng, b=2, sq=150, g=3, npre=5,
                             bs=16, int8=int8)
    got = ops.paged_prefill_attention(*args, **kw)
    _assert_close(got, _plain_fp32(ref.paged_prefill_attention_ref, *args,
                                   **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True])
def test_prefill_kernel_window_hides_prefix_tiles(card, dtype, int8):
    """npre = 12 blocks of 16 (three 64-key prefix tiles), window 40: the
    first two tiles are hidden from every row (skipped), and the rows
    from query 40 on see no prefix key at all."""
    rng = np.random.default_rng(13 + int8)
    args, kw = _prefill_case(card, dtype, rng, b=2, sq=100, g=2, npre=12,
                             bs=16, int8=int8)
    got = ops.paged_prefill_attention(*args, window=40, **kw)
    _assert_close(got, _plain_fp32(ref.paged_prefill_attention_ref, *args,
                                   window=40, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,skv,h,kh,dh,causal,window", FLASH_SWEEP)
def test_flash_kernel_matches_plain(card, dtype, b, sq, skv, h, kh, dh,
                                    causal, window):
    rng = np.random.default_rng(sq + skv + h)
    q, k, v = _on(card, dtype, rng.normal(size=(b, sq, h, dh)).astype(
        np.float32), *(rng.normal(size=(b, skv, kh, dh)).astype(np.float32)
                       for _ in range(2)))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    want = _plain_fp32(ref.flash_attention_ref, q, k, v, causal=causal,
                       window=window)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_reads_strided_inputs(card, dtype):
    """(B, H, S, Dh) storage seen as (B, S, H, Dh): no copy needed."""
    rng = np.random.default_rng(5)
    q, k, v = (t.transpose(1, 2) for t in _on(card, dtype, *(
        rng.normal(size=(2, n, 300, 64)).astype(np.float32)
        for n in (6, 2, 2))))
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v, window=77)
    want = _plain_fp32(ref.flash_attention_ref, q, k, v, window=77)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", RMSNORM_SWEEP)
def test_rmsnorm_kernel_matches_plain(card, dtype, rows, d):
    rng = np.random.default_rng(rows + d)
    x, s = _on(card, dtype, (rng.normal(size=(rows, d)) * 3).astype(
        np.float32), rng.normal(size=(d,)).astype(np.float32))
    ops.reset_launch_counts()
    got = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == 1
    # whole 16-byte vectors take the vector kernel, other widths the scalar
    assert rmsnorm_kernel.launches_vector == int(d % (16 // x.element_size())
                                                 == 0)
    _assert_close(got, _plain_fp32(ref.rmsnorm_ref, x, s), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_on_an_unaligned_view(card, dtype):
    """A contiguous view that starts off a 16-byte boundary takes the
    scalar kernel; the same rows aligned take the vector kernel."""
    rng = np.random.default_rng(9)
    rows, d = 33, 3072
    buf = torch.from_numpy((rng.normal(size=rows * d + 1) * 3).astype(
        np.float32)).to(card, dtype)
    x = buf[1:].view(rows, d)
    s = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)).to(
        card, dtype)
    ops.reset_launch_counts()
    got = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rmsnorm_kernel.launches == 1 and rmsnorm_kernel.launches_vector == 0
    _assert_close(got, _plain_fp32(ref.rmsnorm_ref, x, s), dtype)
    got = ops.rmsnorm(x.clone(), s)
    torch.cuda.synchronize()
    assert rmsnorm_kernel.launches_vector == 1
    _assert_close(got, _plain_fp32(ref.rmsnorm_ref, x, s), dtype)


def test_rmsnorm_kernel_mixed_scale_type_and_leading_dims(card):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(3, 5, 7, 384)).astype(
        np.float32)).to(card, torch.bfloat16)
    s = torch.from_numpy(rng.normal(size=(384,)).astype(np.float32)).to(card)
    got = ops.rmsnorm(x, s, eps=1e-6)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    want = ref.rmsnorm_ref(x.float(), s, eps=1e-6).to(torch.bfloat16)
    _assert_close(got, want, torch.bfloat16)


def test_kernels_raise_on_types_they_do_not_take(card):
    x = torch.ones(4, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.rmsnorm(x, torch.ones(64, device=card, dtype=torch.float16))
    q = torch.ones(1, 8, 2, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q, q)
    q = torch.ones(1, 8, 2, 48, device=card)      # no Dh=48 instance
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)


def test_bf16_kernels_raise_on_unaligned_or_uninstantiated(card):
    """The tensor-core kernels copy 16-byte rows: a bf16 view that starts
    off a 16-byte boundary, or whose strides are not whole 16 bytes,
    raises rather than being copied; so do a bf16 head width with no
    instance and a block size that is not a multiple of 8."""
    bf = dict(device=card, dtype=torch.bfloat16)
    q = torch.ones(1, 8, 2, 64, **bf)
    shifted = torch.ones(1 * 8 * 2 * 64 + 1, **bf)[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(shifted, q, q)
    wide = torch.ones(1, 8, 2, 68, **bf)[..., :64]     # head stride 136 B
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(q, wide, wide)
    odd = torch.ones(1, 8, 2, 65, **bf)[..., :64]      # head stride 130 B
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(odd, q, q)
    q48 = torch.ones(1, 8, 2, 48, **bf)
    with pytest.raises(ValueError, match="d_head"):
        ops.flash_attention(q48, q48, q48)
    tab = torch.tensor([[1]], dtype=torch.int32, device=card)

    def prefill(dh, bs, shift=0):
        pool = torch.ones(3 * bs * 2 * dh + shift, **bf)[shift:].view(
            3, bs, 2, dh)
        x = torch.ones(1, 8, 2, dh, **bf)
        return ops.paged_prefill_attention(x, x, x, pool, pool, tab)

    with pytest.raises(ValueError, match="d_head"):
        prefill(48, 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        prefill(64, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        prefill(64, 16, shift=1)
    prefill(64, 8)                 # the smallest block size it takes
    prefill(16, 16)


def test_missing_kernel_raises_without_fallback(card, monkeypatch):
    """A library without the kernel's symbol raises; nothing falls back
    to the plain version."""
    class Lib:
        repro_cuda_error_string = None
    monkeypatch.setattr(_build, "load_library", lambda: Lib())
    x = torch.ones(4, 64, device=card)
    with pytest.raises(AttributeError):
        ops.rmsnorm(x, torch.ones(64, device=card))
    q = torch.ones(1, 8, 2, 64, device=card)
    with pytest.raises(AttributeError):
        ops.flash_attention(q, q, q)


def _agreement(a: dict, b: dict) -> float:
    """Mean longest-common-prefix share of two rid -> stream maps."""
    fracs = []
    for rid, x in a.items():
        y = b[rid]
        lcp = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v),
                   min(len(x), len(y)))
        fracs.append(lcp / max(len(x), len(y), 1))
    return sum(fracs) / len(fracs)


def _card_vs_cpu(card, engine_kw, serve_kw, budget=12, step=1):
    c = get_config("llama3.2-3b").reduced(dtype="float32",
                                          param_dtype="float32")
    params = lm.init(c, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, c.vocab, size=32)
    reqs = [Request(rid=i, prompt=np.concatenate(
                [shared, rng.integers(0, c.vocab, size=5 + step * i)]
            ).astype(np.int32), max_new_tokens=budget) for i in range(8)]
    streams, engines = {}, {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _to(params, card)
        eng = ServeEngine(c, p, cache="paged", block_size=16,
                          prefix_cache=True, device=dev, **engine_kw)
        ops.reset_launch_counts()
        out = eng.serve(reqs, **serve_kw)
        if dev == "cuda":
            counts = ops.launch_counts()
            assert counts["paged_decode_attention"] > 0
            assert counts["paged_prefill_attention"] > 0
        assert all(r.n_tokens == budget for r in out.results)
        streams[dev] = {r.rid: r.tokens for r in out.results}
        engines[dev] = eng
    return _agreement(streams["cpu"], streams["cuda"]), engines


def test_engine_on_card_matches_cpu(card):
    """Reduced fp32 model: the card (kernels) and the CPU (plain
    versions) serve the same greedy streams, prefix hits included (LCP
    agreement >= 0.95: summation order differs, so a near-tie may
    flip)."""
    agree, _ = _card_vs_cpu(card, dict(n_slots=4, max_len=64), {})
    assert agree >= 0.95


@pytest.mark.parametrize("sched", ["phased", "chunked"])
def test_int8_engine_on_card_matches_cpu(card, sched):
    """int8 pools: every decode step and every paged prefill on the card
    runs the kernels' int8 paths."""
    agree, _ = _card_vs_cpu(card, dict(n_slots=4, max_len=96,
                                       kv_dtype="int8"),
                            dict(sched=sched), step=4)
    assert paged_decode_attention.launches_int8 == \
        ops.launch_counts()["paged_decode_attention"] > 0
    assert paged_prefill_attention.launches_int8 == \
        ops.launch_counts()["paged_prefill_attention"] > 0
    assert agree >= 0.95


def test_chunked_engine_with_preemption_on_card_matches_cpu(card):
    """A pool of two full slots plus trash for four slots: the chunked
    scheduler preempts and replays on both devices, as often."""
    agree, engines = _card_vs_cpu(card, dict(n_slots=4, max_len=128,
                                             n_blocks=17),
                                  dict(sched="chunked"), budget=40, step=4)
    assert engines["cuda"].preemptions >= 1
    assert engines["cuda"].replayed_tokens >= 1
    assert engines["cuda"].preemptions == engines["cpu"].preemptions
    assert agree >= 0.95


def test_slotted_engine_on_card_matches_cpu(card):
    """The slotted cache on the card serves the CPU's greedy streams and
    launches no paged kernel (dense rows go through ``sdpa``)."""
    c = get_config("llama3.2-3b").reduced(dtype="float32",
                                          param_dtype="float32")
    params = lm.init(c, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, c.vocab, size=5 + 3 * i)
                    .astype(np.int32), max_new_tokens=12) for i in range(8)]
    streams = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _to(params, card)
        eng = ServeEngine(c, p, n_slots=4, max_len=64, cache="slotted",
                          block_size=16, device=dev)
        ops.reset_launch_counts()
        out = eng.serve(reqs)
        assert all(r.n_tokens == 12 for r in out.results)
        streams[dev] = {r.rid: r.tokens for r in out.results}
    assert sum(ops.launch_counts().values()) == 0
    assert _agreement(streams["cpu"], streams["cuda"]) >= 0.95


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("per_row", [True, False])
def test_dense_decode_attention_on_card_matches_cpu(card, window, per_row):
    """Both dense decode branches (per-row positions, one shared
    position) on the card against their CPU run, fp32, caches included,
    at the fp32 card gate."""
    import dataclasses
    c = dataclasses.replace(get_config("llama3.2-3b").reduced(
        dtype="float32", param_dtype="float32"), attn_window=window)
    p = blocks.layer(lm.init(c, torch.Generator().manual_seed(0),
                             "cpu")["layers"]["slot0"]["attn"], 0)
    rng = np.random.default_rng(1)
    b, t = 3, 24
    x = torch.from_numpy(rng.normal(size=(b, 1, c.d_model))
                         .astype(np.float32))
    kv = [torch.from_numpy(rng.normal(size=(b, t, c.n_kv_heads, c.d_head))
                           .astype(np.float32)) for _ in range(2)]
    pos = torch.tensor([0, 7, 23], dtype=torch.int32) if per_row else 17
    want_kv = [a.clone() for a in kv]
    want = attention.decode_attention(c, p, x, *want_kv, pos)
    got_kv = [a.to(card) for a in kv]
    got = attention.decode_attention(
        c, _to(p, card), x.to(card), *got_kv,
        pos.to(card) if per_row else pos)
    _assert_close(got.cpu(), want, torch.float32)
    for g, w in zip(got_kv, want_kv):
        _assert_close(g.cpu(), w, torch.float32)


# ---------------------------------------------------------------------------
# The moe, ssm and hybrid families on the card
# ---------------------------------------------------------------------------

#: (name, H, Kh, Dh) of the paged decode at the families' attention
#: layouts: granite-moe-3b-a800m (Dh 64, G 3) and jamba-v0.1-52b (Dh 128,
#: G 4, no RoPE: the kernel sees the same q either way)
FAMILY_DECODE = [("granite-moe", 24, 8, 64), ("jamba", 32, 8, 128)]
FAMILY_ARCHS = ["granite-moe-3b-a800m", "mamba2-1.3b", "jamba-v0.1-52b",
                "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name,h,kh,dh", FAMILY_DECODE)
def test_family_shaped_decode_matches_plain(card, name, h, kh, dh, int8,
                                            dtype):
    """Eight slots at the family's head shapes over a 1024-token table
    (64 blocks of 16), one slot idle on the trash block."""
    rng = np.random.default_rng(h + dh)
    b, bs, nb = 8, 16, 64
    n_blocks = 1 + b * nb
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(b, nb)
    tables[0, 1:] = 0
    lengths = rng.integers(1, nb * bs + 1, size=b).astype(np.int32)
    lengths[0] = 1
    q = torch.from_numpy(rng.normal(size=(b, h, dh)).astype(np.float32)).to(
        card, dtype)
    tab = torch.from_numpy(tables.astype(np.int32)).to(card)
    lens = torch.from_numpy(lengths).to(card)
    kw = {}
    if int8:
        pools = [torch.from_numpy(rng.integers(-127, 128, size=(
            n_blocks, bs, kh, dh)).astype(np.int8)).to(card) for _ in "kv"]
        kw = {f"{n}_scale": torch.from_numpy(rng.uniform(
            0.001, 0.02, size=(n_blocks, kh)).astype(np.float32)).to(card)
            for n in "kv"}
    else:
        pools = [torch.from_numpy(rng.normal(size=(
            n_blocks, bs, kh, dh)).astype(np.float32)).to(card, dtype)
            for _ in "kv"]
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(q, *pools, tab, lens, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == 1
    want = _plain_fp32(ref.paged_decode_attention_ref, q, *pools, tab, lens,
                       **kw)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("cache", ["paged", "slotted"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_engine_on_card_matches_cpu(card, arch, cache):
    """Reduced fp32 families served on the card (kernels) and on the CPU
    (plain versions) from the same weights, through ``chip_smoke``'s
    phase-9 check: LCP agreement >= 0.95 (a near-tie in a router's top-k
    or an argmax may flip); on the paged cache the decode kernel launches
    once per attention layer and micro-step (never on mamba2)."""
    assert chip_smoke.family_agreement(arch, card, cache) >= 0.95


@pytest.mark.parametrize("arch", FAMILY_ARCHS[:3])
def test_family_train_step_on_card_matches_cpu(card, arch):
    """Three AdamW steps of the reduced fp32 moe, ssm and hybrid configs
    on the card and on the CPU from the same weights, through
    ``chip_smoke``'s phase-9 check: losses and aux at rtol 1e-4 (TF32
    off)."""
    assert len(chip_smoke.family_train_agreement(arch, card)) == 3


@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-34b"])
def test_generate_on_card_matches_cpu(card, arch):
    """Reduced fp32 whisper-small and llava-next-34b through
    ``BatchedServer.generate`` on the card and on the CPU from the same
    weights, prompts and seeded random side inputs, through
    ``chip_smoke``'s phase-10 check: LCP agreement >= 0.95 (TF32 off)."""
    assert chip_smoke.generate_agreement(arch, card) >= 0.95


@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-34b"])
def test_encdec_vlm_train_step_on_card_matches_cpu(card, arch):
    """Three AdamW steps of reduced fp32 whisper-small and llava-next-34b
    (seeded random frames and patches) on the card and on the CPU:
    losses at rtol 1e-4 (TF32 off)."""
    assert len(chip_smoke.family_train_agreement(arch, card)) == 3


def test_chunked_q_on_card_matches_full_sdpa(card):
    """``sdpa_chunked_q`` on the card against full ``sdpa`` under the same
    mask (causal, windowed, bidirectional; fp32, TF32 off) at 1e-5."""
    assert chip_smoke.chunked_q_agreement(card) <= 1e-5


def test_faulted_chunked_serve_equals_fault_free_on_card(card):
    """A reduced fp32 llama3.2-3b served chunked on the paged pool on the
    card, with the ``decode_fault`` schedule and without: the slot fault
    fires, the victim resumes through the replay, and the streams are
    equal; the decode kernel launches once per layer and micro-step,
    replays included."""
    from repro_torch.faults.schedule import FaultSchedule
    c = get_config("llama3.2-3b").reduced(dtype="float32",
                                          param_dtype="float32")
    params = tree.tree_map(lambda t: t.to(card), lm.init(
        c, torch.Generator().manual_seed(4), "cpu"))
    rng = np.random.default_rng(4)
    reqs = [Request(rid=i, prompt=rng.integers(0, c.vocab, int(
        rng.integers(10, 60))).astype(np.int32),
        max_new_tokens=int(rng.integers(12, 30))) for i in range(6)]
    streams = {}
    for preset in ("none", "decode_fault"):
        eng = ServeEngine(c, params, n_slots=3, max_len=128, cache="paged",
                          block_size=16, sched="chunked", chunk_tokens=16,
                          device=card)
        ops.reset_launch_counts()
        out = eng.serve(reqs, faults=FaultSchedule.from_preset(preset,
                                                               seed=0))
        micro = sum(st.n_steps for st in out.steps if st.kind == "decode")
        assert ops.launch_counts()["paged_decode_attention"] == \
            micro * c.n_layers
        assert eng.injected_faults == (preset == "decode_fault")
        streams[preset] = {r.rid: list(r.tokens) for r in out.results}
        assert all(len(streams[preset][q.rid]) == q.max_new_tokens
                   for q in reqs)
    assert streams["decode_fault"] == streams["none"]


def _matmul_load(card, seconds: float, n: int = 8192):
    """Back-to-back bf16 matmuls on the card for about ``seconds``."""
    a = torch.randn(n, n, device=card, dtype=torch.bfloat16)
    t_end = time.monotonic() + seconds
    while time.monotonic() < t_end:
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


def test_nvml_energy_counter_matches_power_trapezoid(card):
    """Over 10 s of steady matmul load (after 2 s of warm-up), the energy
    counter's difference and the trapezoid of the board power reading
    (a one-second average) agree within 5 %."""
    _matmul_load(card, 2.0)
    power, energy = NvmlPower(card.index or 0), NvmlEnergy(card.index or 0)
    with get_power([power, energy], interval_ms=20) as scope:
        _matmul_load(card, 10.0)
    rows = {r["device"]: r for r in scope.energy()[0].records()}
    by_power = rows["nvml:nvml:0"]
    by_counter = rows["nvml_energy:nvml:0"]
    print(f"\nnvml power trapezoid {by_power['energy_wh']:.6f} Wh "
          f"({by_power['avg_power_w']:.1f} W), nvml_energy counter "
          f"{by_counter['energy_wh']:.6f} Wh ({by_counter['avg_power_w']:.1f}"
          f" W) over {by_power['duration_s']:.2f} s, "
          f"{len(scope.df)} samples")
    assert by_power["duration_s"] >= 10.0
    assert by_counter["energy_wh"] > 0
    assert abs(by_counter["energy_wh"] / by_power["energy_wh"] - 1) <= 0.05
    power.close()
    energy.close()


def test_nvml_energy_counter_update_interval(card):
    """Read the counter in a tight loop while the card runs queued
    matmuls: it advances in steps; print their interval."""
    energy = NvmlEnergy(card.index or 0)
    a = torch.randn(16384, 16384, device=card, dtype=torch.bfloat16)
    for _ in range(200):                  # ~2-3 s of queued work
        torch.mm(a, a)
    changes, reads = [], 0
    last = energy.read()["nvml:0"]
    t_end = time.monotonic() + 2.0
    while time.monotonic() < t_end:
        v = energy.read()["nvml:0"]
        reads += 1
        if v != last:
            changes.append(time.monotonic())
            last = v
    torch.cuda.synchronize()
    gaps = np.diff(changes) * 1e3
    assert len(gaps) >= 3, (len(changes), reads)
    print(f"\nnvml_energy counter: {reads} reads in 2 s, {len(changes)} "
          f"changes; update interval median {np.median(gaps):.2f} ms, min "
          f"{gaps.min():.2f} ms, max {gaps.max():.2f} ms")
    energy.close()


def _assert_close(got, want, dtype):
    diff = (got.float() - want.float()).abs()
    assert (diff <= TOL[dtype] * (1 + want.float().abs())).all(), \
        diff.max().item()
    if dtype == torch.bfloat16:
        assert (diff > 0).float().mean().item() <= 1e-2


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------


def test_train_step_on_card_matches_cpu(card):
    """Reduced fp32 gpt-800m, three AdamW steps of two microbatches from
    the same weights and batches on the card and on the CPU: losses at
    rtol 1e-4 (summation order differs). A step moves a leaf by at most
    lr * (1 + wd * |p|), so the params may differ by at most twice the
    sum of the three steps' moves; the measured difference is printed."""
    c = get_config("gpt-800m").reduced(dtype="float32",
                                       param_dtype="float32")
    oc = OptConfig(warmup=2, total_steps=100)
    step = make_train_step(c, oc, StepConfig(microbatches=2))
    p0, o0 = init_train_state(c, oc, torch.Generator().manual_seed(0), "cpu")
    p1, o1 = tree.tree_map(lambda t: t.to(card), (p0, o0))
    data = {d: make_data_fn(c, 8, 64, seed=0, device=d) for d in ("cpu",
                                                                 card)}
    for i in range(3):
        p0, o0, m0 = step(p0, o0, data["cpu"](i))
        p1, o1, m1 = step(p1, o1, data[card](i))
        np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                                   rtol=1e-4)
    worst = max((a.cpu() - b).abs().max().item() for a, b in
                zip(tree.leaves(p1), tree.leaves(p0)))
    moves = sum(oc.lr * (1 + oc.weight_decay * max(
        b.abs().max().item() for b in tree.leaves(p0))) for _ in range(3))
    print(f"\ntrain step card vs cpu: params max |diff| {worst:.3e} "
          f"(bound {2 * moves:.3e})")
    assert worst <= 2 * moves


def test_checkpoint_round_trip_of_card_tensors(card, tmp_path):
    """bf16, fp32 and 0-d int32 card tensors restore bit-exactly onto
    the card; ``save_async`` returns only once its host snapshot is
    taken, so an in-place update right after it stays out of the
    checkpoint."""
    gen = torch.Generator(device=card).manual_seed(0)
    t = {"w": torch.randn(64, 33, generator=gen, device=card)
         .to(torch.bfloat16),
         "m": torch.randn(1000, generator=gen, device=card),
         "step": torch.tensor(7, dtype=torch.int32, device=card)}
    want = tree.tree_map(lambda x: x.cpu().clone(), t)
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save_async(t, 1)
    for x in tree.leaves(t):
        x.add_(1)                       # the next optimizer step, in place
    mgr.wait()
    got, manifest = ckpt.restore(t, tmp_path)
    assert manifest["step"] == 1
    for a, b, x in zip(tree.leaves(got), tree.leaves(want), tree.leaves(t)):
        assert a.device == x.device and a.dtype == x.dtype
        assert torch.equal(a.cpu(), b)


def _two_runs(build):
    """Loss traces and final params of two identical 5-step runs, each
    from ``build() -> (params, opt_state, sync_state, step, data)``."""
    out = []
    for _ in range(2):
        losses, (p, o, s, step, data) = [], build()
        for i in range(5):
            if s is None:
                p, o, m = step(p, o, data(i))
            else:
                p, o, s, m = step(p, o, s, data(i))
            losses.append(m["loss"])
        out.append(([float(x) for x in losses], p))
    return out


@pytest.mark.parametrize("path", ["train_step", "dp_int8_k4"])
def test_train_step_on_card_is_deterministic(card, path):
    """Full-width bf16 gpt-117m (8 x 128 zipf tokens: many repeated
    token ids, so the embedding gradient sums many rows per id), five
    steps twice from the same seed: element-equal loss traces and
    params, through the plain step (the resilience workload's) and the
    int8 dp step with four microbatches (the llm_train workload's).
    Prints the ops that ``torch.use_deterministic_algorithms`` (warn
    only) flags on one step."""
    c = get_config("gpt-117m")
    oc = OptConfig(warmup=2, total_steps=100)

    def build():
        p, o = init_train_state(c, oc, torch.Generator(device=card)
                                .manual_seed(0), card)
        data = make_data_fn(c, 8, 128, seed=0, device=card)
        if path == "train_step":
            return p, o, None, make_train_step(c, oc), data
        sync = gs.default_sync("int8", card)
        step = gs.make_dp_train_step(c, oc, StepConfig(microbatches=4),
                                     sync=sync)
        return p, o, gs.init_sync_state(p, sync), step, data

    (l1, p1), (l2, p2) = _two_runs(build)
    assert l1 == l2, (l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(p1),
                                                 tree.leaves(p2)))
    p, o, s, step, data = build()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if s is None:
                step(p, o, data(0))
            else:
                step(p, o, s, data(0))
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(". ")[0][:120] for w in caught})
    print(f"\n{path}: losses {l1}; deterministic mode flags "
          f"{flagged or 'nothing'}")


# ---------------------------------------------------------------------------
# ResNet on the card
# ---------------------------------------------------------------------------


def _images(c, n, device):
    imgs, labels = synthetic_images(n, c.img_size, c.n_classes)
    return {"images": torch.from_numpy(imgs).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def test_resnet50_full_width_steps_on_card(card):
    """Five steps of full-width bf16 ResNet50 (25,557,032 params, 224 x
    224, global batch 16) on one repeated batch: a finite, falling
    loss."""
    oc = OptConfig(warmup=2, total_steps=1000)
    p, o = init_train_state(RESNET50, oc, torch.Generator(device=card)
                            .manual_seed(0), card)
    assert sum(t.numel() for t in tree.leaves(p)) == 25_557_032
    step = make_resnet_train_step(RESNET50, oc)
    batch = _images(RESNET50, 16, card)
    losses = []
    for _ in range(5):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    print(f"\nresnet50 full width, gb=16: losses {losses}")
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_resnet_step_on_card_matches_cpu(card):
    """Reduced fp32 ResNet (width 16, 64 x 64), three AdamW steps from
    the same weights and batches on the card and on the CPU, with TF32
    off (cuDNN convolutions take TF32 by default): losses at rtol 1e-4
    (summation order differs), params within twice the three steps'
    largest moves; the measured difference is printed."""
    c = RESNET50.reduced(img_size=64, width=16, dtype="float32",
                         param_dtype="float32")
    oc = OptConfig(warmup=2, total_steps=100)
    step = make_resnet_train_step(c, oc)
    p0, o0 = init_train_state(c, oc, torch.Generator().manual_seed(0), "cpu")
    p1, o1 = tree.tree_map(lambda t: t.to(card), (p0, o0))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for i in range(3):
            imgs, labels = synthetic_images(8, c.img_size, c.n_classes,
                                            seed=i)
            batch = {"images": torch.from_numpy(imgs),
                     "labels": torch.from_numpy(labels)}
            p0, o0, m0 = step(p0, o0, batch)
            p1, o1, m1 = step(p1, o1, tree.tree_map(lambda t: t.to(card),
                                                    batch))
            np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                                       rtol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    worst = max((a.cpu() - b).abs().max().item() for a, b in
                zip(tree.leaves(p1), tree.leaves(p0)))
    moves = sum(oc.lr * (1 + oc.weight_decay * max(
        b.abs().max().item() for b in tree.leaves(p0))) for _ in range(3))
    print(f"\nresnet step card vs cpu: params max |diff| {worst:.3e} "
          f"(bound {2 * moves:.3e})")
    assert worst <= 2 * moves


def test_checkpoint_round_trip_of_a_resnet_train_state(card, tmp_path):
    """A reduced bf16 ResNet train state on the card, one step in,
    restores bit-exactly onto the card; its leaves are keyed by their
    list indices (``stages/<stage>/<block>/...``)."""
    c = RESNET50.reduced()
    oc = OptConfig(warmup=2, total_steps=100)
    p, o = init_train_state(c, oc, torch.Generator(device=card)
                            .manual_seed(0), card)
    p, o, _ = make_resnet_train_step(c, oc)(p, o, _images(c, 4, card))
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save_sync((p, o), 1)
    got, manifest = ckpt.restore((p, o), tmp_path)
    assert "0/stages/1/0/proj" in manifest["leaves"]
    assert "1/m/stages/3/0/bn3/scale" in manifest["leaves"]
    for a, b in zip(tree.leaves(got), tree.leaves((p, o))):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_heatmap_dp1_cell_on_the_energy_counter(card, tmp_path):
    from repro_torch.bench import cli
    from repro_torch.bench.records import load_records
    rc = cli.main(["run", "--suite", "heatmap", "--points",
                   "placement=dp1,global_batch=8", "--power", "auto",
                   "--out", str(tmp_path), "--quiet"])
    assert rc == 0
    (rec,) = load_records(tmp_path / "heatmap" / "results.json")
    m = rec.metrics
    print(f"\nheatmap dp1 gb=8: {m['tokens_per_s']:.1f} tok/s, "
          f"{m['ms']:.2f} ms, {m['iters']} iters, {m['tokens_per_wh']:.1f} "
          f"tokens/Wh, mfu {m['mfu']:.5f}")
    assert rec.status == "ok" and rec.power_source == "nvml_energy"
    assert m["model_scale"] == "full" and m["n_params"] > 1e8
    assert m["loss_last"] < m["loss_first"]
    assert m["seconds"] * m["iters"] >= 0.5
    for k in ("tokens_per_s", "tokens_per_wh", "mfu", "peak_mem_gb"):
        assert np.isfinite(m[k]) and m[k] > 0, k


@pytest.mark.parametrize("arch", ["gpt-117m", "whisper-small"])
def test_make_data_iter_on_the_card_equals_the_cpu(card, arch):
    c = get_config(arch).reduced()
    on_card = make_data_iter(c, 4, 32, seed=1, device=card)
    on_cpu = make_data_iter(c, 4, 32, seed=1, device="cpu")
    try:
        for _ in range(3):
            a, b = next(on_card), next(on_cpu)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].device.type == "cuda"
                assert torch.equal(a[k].cpu(), b[k]), k
    finally:
        on_card.close()
        on_cpu.close()


def test_fallback_power_keeps_its_column_an_energy_counter(card):
    res = chip_smoke.fallback_probe(card, window_s=3.0, fail_from=5)
    print(f"\nfallback {res['wh_fallback']:.6f} Wh vs counter "
          f"{res['wh_counter']:.6f} Wh over 3 s: rel err "
          f"{res['rel_err']:.5f}; {res['label']}")
    assert res["kind"] == "energy" and res["degraded"]
    assert res["columns"] == ["nvml_energy:nvml:0"]
    assert res["label"] == "nvml_energy+fallback:nvml"
    assert res["fallback_reads"] > 0 and res["wh_fallback"] > 0
    assert res["rel_err"] <= chip_smoke.FALLBACK_TOL


def test_rapl_probe_is_a_bool_and_reads_finite_watts(card):
    from repro_torch.power.methods import RaplPower
    rapl = RaplPower()
    assert isinstance(rapl.available(), bool)
    res = chip_smoke.rapl_probe(card, window_s=0.5)
    print(f"\nRAPL: {res}")
    if res["available"]:
        assert res["watts"] and all(np.isfinite(v) and v >= 0
                                    for v in res["watts"].values())


# ---------------------------------------------------------------------------
# The grouped formulation, the dry run's counts, remat="dots" (card)
# ---------------------------------------------------------------------------


def test_grouped_dense_decode_equals_repeat_in_bf16(card):
    """Phase 1's grouped-vs-repeat check: bf16 at full llama3.2-3b and
    llava-next-34b head shapes, under the card's bf16 gate."""
    chip_smoke.check_grouped_decode(card)


def test_meta_flops_equal_cuda_flops_of_a_reduced_train_step(card):
    import dataclasses
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    c = get_config("llama3.2-3b").reduced()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128,
                                global_batch=4)
    rec = dryrun.real_step(c, shape, card)
    print(f"\n{rec}")
    assert rec["flops_device"] == rec["flops_meta"] > 0
    assert abs(rec["peak_bytes_measured"] - rec["peak_bytes_estimate"]) <= \
        0.10 * rec["peak_bytes_estimate"]


def test_remat_dots_peak_lies_between_none_and_full(card):
    """remat="dots"'s memory gate: one gpt-117m microbatch's
    value_and_grad at batch 8 x 512 peaks higher than with ``"full"``
    and lower than with ``"none"``, with gradients equal to ``"full"``'s
    at 1e-4."""
    from repro_torch.train import step as train_step
    c = get_config("gpt-117m")
    params = lm.init(c, torch.Generator(device=card).manual_seed(0), card)
    gen = torch.Generator(device=card).manual_seed(1)
    toks = torch.randint(0, c.vocab, (8, 512), generator=gen, device=card)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    peaks, grads = {}, {}
    for remat in ("none", "dots", "full"):
        vg = train_step.value_and_grad(train_step.make_loss_fn(
            c, StepConfig(remat=remat)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(card)
        torch.cuda.reset_peak_memory_stats(card)
        _, grads[remat] = vg(params, batch)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated(card) - base
    print(f"\npeak above the params, GB: " + ", ".join(
        f"{k} {v / 1e9:.3f}" for k, v in peaks.items()))
    assert peaks["full"] < peaks["dots"] < peaks["none"]
    for a, b in zip(tree.leaves(grads["dots"]), tree.leaves(grads["full"])):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-4, atol=1e-4)


def test_an_nccl_world_larger_than_the_cards_raises(card):
    """Nothing switches the backend silently: an NCCL world of one rank
    more than the machine's cards raises before a rank starts."""
    from repro_torch.launch import mesh as mesh_mod
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} ranks needs {n} cards"):
        mesh_mod.spawn(chip_smoke.par_rank_int8, n, device=card)


def test_int8_dp2_ranks_on_the_card_match_cpu_ranks(card):
    """Two ranks share the card over gloo: the reduced fp32 gpt-800m's
    int8 dp2 run against the same run on two CPU ranks, error-feedback
    codes within one in at most 0.1 % of entries (phase 13b's check)."""
    from repro_torch.launch import mesh as mesh_mod
    on_card = mesh_mod.spawn(chip_smoke.par_rank_int8, 2, device=card,
                             backend="gloo")
    on_cpu = mesh_mod.spawn(chip_smoke.par_rank_int8, 2, device="cpu")
    flipped = total = 0
    for g, w in zip(on_card, on_cpu):
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-4)
        diff = np.abs(g["sync"] - w["sync"])
        assert (diff <= 2.5 * np.abs(w["sync"]).max(-1, keepdims=True)
                + 1e-7).all()
        flipped += int((diff > 1e-6).sum())
        total += diff.size
    assert flipped <= 1e-3 * total, (flipped, total)
