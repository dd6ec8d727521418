"""The port's CUDA kernels on the card, against their plain versions.

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

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.requests import Request

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -7}
DTYPES = [torch.float32, torch.bfloat16]
DECODE = list(itertools.product([8, 16], [1, 2, 3], [None, 24]))
PREFILL = list(itertools.product([8, 16], [1, 2, 3], [1, 3], [None, 24]))
KH, DH = 4, 128


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
def test_decode_kernel_matches_plain(card, dtype, bs, g, window):
    rng = np.random.default_rng(bs * 10 + g)
    b, nb = 5, 256 // bs
    n_blocks = 1 + b * nb
    pool = lambda: rng.normal(size=(n_blocks, bs, KH, DH)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(b, nb)
    lengths = rng.integers(1, nb * bs + 1, size=b).astype(np.int32)
    lengths[0] = 1
    tables[0, 1:] = 0                               # unowned -> trash block
    q = rng.normal(size=(b, KH * g, DH)).astype(np.float32)
    args = _on(card, dtype, q, pool(), pool(), tables.astype(np.int32),
               lengths)
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == 1
    want = _plain_fp32(ref.paged_decode_attention_ref, *args, window=window)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs,g,npre,window", PREFILL)
def test_prefill_kernel_matches_plain(card, dtype, bs, g, npre, window):
    rng = np.random.default_rng(bs * 100 + g * 10 + npre)
    b, sq = 3, 40                                   # ragged last tiles
    n_blocks = 2 + b * npre
    pool = lambda: rng.normal(size=(n_blocks, bs, KH, DH)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_blocks))[:b * npre]
    arrays = (rng.normal(size=(b, sq, KH * g, DH)).astype(np.float32),
              rng.normal(size=(b, sq, KH, DH)).astype(np.float32),
              rng.normal(size=(b, sq, KH, DH)).astype(np.float32),
              pool(), pool(), tables.reshape(b, npre).astype(np.int32))
    args = _on(card, dtype, *arrays)
    ops.reset_launch_counts()
    got = ops.paged_prefill_attention(*args, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_prefill_attention"] == 1
    want = _plain_fp32(ref.paged_prefill_attention_ref, *args,
                      window=window)
    _assert_close(got, want, dtype)


def test_engine_on_card_matches_cpu(card):
    """Reduced fp32 model: the card (kernels) and the CPU (plain
    versions) serve the same greedy streams, prefix hits included (LCP
    agreement >= 0.95: summation order differs, so a near-tie may
    flip)."""
    c = get_config("llama3.2-3b").reduced(dtype="float32",
                                          param_dtype="float32")
    params = lm.init(c, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, c.vocab, size=32)
    reqs = [Request(rid=i, prompt=np.concatenate(
                [shared, rng.integers(0, c.vocab, size=5 + i)]).astype(
                    np.int32), max_new_tokens=12) for i in range(8)]
    streams = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _to(params, card)
        eng = ServeEngine(c, p, n_slots=4, max_len=64, block_size=16,
                          prefix_cache=True, device=dev)
        ops.reset_launch_counts()
        out = eng.serve(reqs)
        if dev == "cuda":
            counts = ops.launch_counts()
            assert counts["paged_decode_attention"] > 0
            assert counts["paged_prefill_attention"] > 0
        streams[dev] = {r.rid: r.tokens for r in out.results}
    fracs = []
    for rid, a in streams["cpu"].items():
        b = streams["cuda"][rid]
        lcp = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   len(a))
        fracs.append(lcp / len(a))
    assert sum(fracs) / len(fracs) >= 0.95


def _plain_fp32(fn, *args, **kw):
    up = [a.float() if a.is_floating_point() else a for a in args]
    return fn(*up, **kw).to(args[0].dtype)


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
