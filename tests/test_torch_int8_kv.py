"""int8 KV serving: ``repro_torch`` against ``repro`` on the CPU.

The same inputs, made from numpy seeds, go through the JAX function and
its port:

  * ``serve.cache._quantize_block`` and ``models.attention.
    _quantized_block_write`` give EQUAL int8 codes and fp32 scales (both
    divide, round half to even and clamp to +-127 in fp32; the reference
    runs op by op here, as its source reads), and the port's write keeps
    the reference's monotone-scale invariant;
  * ``insert_paged_prefill`` quantizes on insert as the reference does
    (pad rows dropped), ``copy_blocks`` copies the scale leaves, and
    ``PagedKVCache(kv_dtype="int8")`` has the reference's integers for
    ``pool_bytes``, ``pool_bytes_fp``, ``bytes_per_block`` and
    ``max_concurrency``;
  * the int8 decode plain version is within 1e-3 (the reference's kernel
    gate) of ``repro.kernels.ref.paged_decode_attention_ref(k_scale=...)``
    and of the Pallas decode kernel in interpret mode;
  * the int8 engine, phased and chunked, prefix cache off and on, serves
    the reference int8 engine's streams: equal token counts and
    ``stream_agreement`` >= 0.95 (bit-identity across frameworks is not
    promised); the port's own fp32-vs-int8 agreement is recorded, not
    gated (the reference misses its own 0.6 drill).
"""
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench.workloads.serve import stream_agreement
from repro.configs import get_config as ref_get_config
from repro.kernels import ref as jref
from repro.kernels.decode_attention import (
    paged_decode_attention as pallas_decode,
)
from repro.models import attention as ref_attention
from repro.models import lm as ref_lm
from repro.serve import cache as ref_cache
from repro.serve import engine as ref_engine
from repro.serve import requests as ref_requests
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    paged_decode_attention as cuda_decode,
)
from repro_torch.models import attention
from repro_torch.serve import cache as cache_lib
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.requests import Request

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
KH, DH, B = 2, 16, 3
DECODE = list(itertools.product([8, 16], [1, 3], [None, 24]))
DECODE_PALLAS = [(8, 1, None), (16, 3, 24), (8, 2, 24)]
_jit = functools.partial(jax.jit, static_argnames=("window",))
jref_decode = _jit(jref.paged_decode_attention_ref)
pallas_decode = _jit(functools.partial(pallas_decode, interpret=True))
# op by op, as written: under jit, XLA on the CPU turns the division by
# the constant 127 into a multiply by its reciprocal, which can move a
# scale by one ulp; the port follows the source (a true division)
jref_write = ref_attention._quantized_block_write
N_SLOTS, MAX_LEN, BS = 3, 96, 16


def _quantize_np(pool):
    """(n_blocks, bs, Kh, Dh) fp32 -> int8 codes and (n_blocks, Kh)
    scales through the reference's quantiser (one layer)."""
    q, sc = ref_cache._quantize_block(jnp.asarray(pool)[None])
    return np.array(q[0]), np.array(sc[0])


# ---------------------------------------------------------------------------
# quantization: equal codes and scales
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,spread", [(0, 4.0), (1, 0.01), (2, 300.0)])
def test_quantize_block_matches_reference(seed, spread):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 5, 16, 3, 8)) * spread).astype(np.float32)
    x[:, 3] = 0.0                                   # an untouched block
    got_q, got_sc = cache_lib._quantize_block(torch.from_numpy(x))
    want_q, want_sc = ref_cache._quantize_block(jnp.asarray(x))
    assert got_q.dtype == torch.int8 and got_sc.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_sc.numpy(), np.asarray(want_sc))
    assert (got_q[:, 3] == 0).all() and (got_sc[:, 3] == 0).all()


def test_quantize_block_rounds_half_to_even_as_reference():
    """maxabs 127 gives scale 1.0, so x / scale lands exactly on .5: codes
    must round half to even (2.5 -> 2, 3.5 -> 4, -0.5 -> -0)."""
    x = np.zeros((1, 1, 4, 1, 4), np.float32)
    x[0, 0, 0, 0] = [127.0, 2.5, 3.5, -0.5]
    x[0, 0, 1, 0] = [-1.5, 0.5, 126.5, -126.5]
    got_q, got_sc = cache_lib._quantize_block(torch.from_numpy(x))
    want_q, _ = ref_cache._quantize_block(jnp.asarray(x))
    assert float(got_sc) == 1.0
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_q[0, 0, 0, 0].tolist() == [127, 2, 4, 0]
    assert got_q[0, 0, 1, 0].tolist() == [-2, 0, 126, -126]


def _write_inputs(seed, token_scale):
    rng = np.random.default_rng(seed)
    n, bs = 6, 8
    pool, scale = _quantize_np(
        (rng.normal(size=(n, bs, KH, DH)) * 3.0).astype(np.float32))
    new = (rng.normal(size=(4, KH, DH)) * token_scale).astype(np.float32)
    blk = np.array([1, 4, 2, 5], np.int32)
    off = np.array([5, 0, 7, 3], np.int32)
    return pool, scale, new, blk, off


@pytest.mark.parametrize("seed,token_scale", [(3, 0.3), (4, 3.0), (5, 40.0)])
def test_quantized_block_write_matches_reference(seed, token_scale):
    """Tokens inside, around and far outside the blocks' range: the
    in-place port writes the reference's codes and scales exactly."""
    pool, scale, new, blk, off = _write_inputs(seed, token_scale)
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scale.copy())
    attention._quantized_block_write(tp, ts, torch.from_numpy(new),
                                     torch.from_numpy(blk).long(),
                                     torch.from_numpy(off).long())
    wp, ws = jref_write(jnp.asarray(pool), jnp.asarray(scale),
                        jnp.asarray(new), jnp.asarray(blk), jnp.asarray(off))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    untouched = [i for i in range(pool.shape[0]) if i not in blk]
    np.testing.assert_array_equal(tp.numpy()[untouched], pool[untouched])


def test_quantized_block_write_trash_duplicates_leave_live_blocks_exact():
    """Idle slots all park on the trash block 0: duplicate writes there
    are harmless, and the live blocks still match the reference."""
    pool, scale, new, _, _ = _write_inputs(6, 1.0)
    blk = np.array([0, 3, 0, 0], np.int32)
    off = np.array([7, 2, 7, 7], np.int32)
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scale.copy())
    attention._quantized_block_write(tp, ts, torch.from_numpy(new),
                                     torch.from_numpy(blk).long(),
                                     torch.from_numpy(off).long())
    wp, ws = jref_write(jnp.asarray(pool), jnp.asarray(scale),
                        jnp.asarray(new), jnp.asarray(blk), jnp.asarray(off))
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(wp)[1:])
    np.testing.assert_array_equal(ts.numpy()[1:], np.asarray(ws)[1:])


def test_quantized_block_write_monotone_scale():
    """The reference's invariant, on the port: a token inside the old
    range leaves the scale and every other code bit-unchanged; one
    outside grows the scale, which never shrinks."""
    pool, scale, _, _, _ = _write_inputs(7, 1.0)
    blk = torch.tensor([1, 2])
    off = torch.tensor([5, 2])
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scale.copy())
    small = torch.empty(2, KH, DH).uniform_(-0.5, 0.5,
                                            generator=torch.Generator()
                                            .manual_seed(0))
    attention._quantized_block_write(tp, ts, small, blk, off)
    np.testing.assert_array_equal(ts.numpy(), scale)
    for b_, o_ in ((1, 5), (2, 2)):
        keep = np.ones(pool.shape[1], bool)
        keep[o_] = False
        np.testing.assert_array_equal(tp.numpy()[b_][keep], pool[b_][keep])
    s1 = ts.clone()
    attention._quantized_block_write(tp, ts, torch.full((2, KH, DH), 50.0),
                                     blk, off)
    assert (ts >= s1).all() and (ts[blk] > s1[blk]).all()
    deq = tp[1, 5].float() * ts[1][:, None]
    assert (deq - 50.0).abs().max() <= ts[1].max() / 2.0 + 1e-6


# ---------------------------------------------------------------------------
# the int8 pool layout
# ---------------------------------------------------------------------------


def _config():
    return (ref_get_config("llama3.2-3b").reduced(dtype="float32",
                                                  param_dtype="float32"),
            get_config("llama3.2-3b").reduced(dtype="float32",
                                              param_dtype="float32"))


@pytest.mark.parametrize("n_slots,max_len,bs,n_blocks",
                         [(3, 96, 16, None), (8, 128, 8, 40), (2, 64, 16, 6)])
def test_int8_cache_capacity_equals_reference(n_slots, max_len, bs,
                                              n_blocks):
    rc, c = _config()
    kw = dict(block_size=bs, n_blocks=n_blocks)
    for kv in ("fp32", "int8"):
        want = ref_cache.PagedKVCache(rc, n_slots, max_len, None,
                                      kv_dtype=kv, **kw)
        got = cache_lib.PagedKVCache(c, n_slots, max_len, kv_dtype=kv,
                                     device=torch.device("cpu"), **kw)
        assert (got.pool_bytes, got.pool_bytes_fp, got.bytes_per_block,
                got.max_concurrency) == (
            want.pool_bytes, want.pool_bytes_fp, want.bytes_per_block,
            want.max_concurrency), kv
    tree = got.caches["slot0"]
    assert tree["k"].dtype == torch.int8
    assert tree["k_scale"].shape == (c.n_layers, got.n_blocks, c.n_kv_heads)
    assert tree["v_scale"].dtype == torch.float32


def test_copy_blocks_copies_scale_leaves():
    _, c = _config()
    paged = cache_lib.PagedKVCache(c, 2, 64, block_size=16, kv_dtype="int8",
                                   device=torch.device("cpu"))
    tree = paged.caches["slot0"]
    for name, fill in (("k", 7), ("v", -3), ("k_scale", 0.25),
                       ("v_scale", 0.5)):
        tree[name][:, 1] = fill
    cache_lib.copy_blocks(paged.caches, [1], [3])
    for name, leaf in tree.items():
        torch.testing.assert_close(leaf[:, 3], leaf[:, 1], rtol=0, atol=0)


def test_insert_quantizes_like_reference():
    """A batched prefill's rows (a partial last block, a pad row on block
    id n_blocks, an unowned tail column) go into an int8 pool as the
    reference's codes and scales; the pad ids are dropped."""
    rng = np.random.default_rng(8)
    n_blocks, bs, n_layers = 7, 4, 2
    rows_np = {n: (rng.normal(size=(n_layers, 3, 6, KH, DH)) * 2).astype(
        np.float32) for n in ("k", "v")}
    blocks = np.array([[2, 5], [1, n_blocks], [n_blocks, n_blocks]])

    def pool_tree(lib):
        z = lambda s, d: lib.zeros(s, dtype=d)
        shape = (n_layers, n_blocks, bs, KH, DH)
        return {"slot0": {"k": z(shape, lib.int8), "v": z(shape, lib.int8),
                          "k_scale": z(shape[:2] + (KH,), lib.float32),
                          "v_scale": z(shape[:2] + (KH,), lib.float32)}}

    got = cache_lib.insert_paged_prefill(
        pool_tree(torch), {"slot0": {n: torch.from_numpy(a)
                                     for n, a in rows_np.items()}},
        blocks, block_size=bs)
    with jax.disable_jit():      # op by op, as written (see jref_write)
        want = ref_cache.insert_paged_prefill(
            pool_tree(jnp), {"slot0": {n: jnp.asarray(a)
                                       for n, a in rows_np.items()}},
            jnp.asarray(blocks, jnp.int32), jnp.zeros((3,), jnp.int32),
            block_size=bs)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got["slot0"][name].numpy(),
                                      np.asarray(want["slot0"][name]), name)
    assert (got["slot0"]["k_scale"][:, [0, 3, 4, 6]] == 0).all()


# ---------------------------------------------------------------------------
# the int8 decode plain version
# ---------------------------------------------------------------------------


def _int8_decode_inputs(bs, g, seed, max_len=64):
    rng = np.random.default_rng(seed)
    nb = max_len // bs
    n_blocks = 1 + B * nb
    k_pool, k_sc = _quantize_np(
        rng.normal(size=(n_blocks, bs, KH, DH)).astype(np.float32))
    v_pool, v_sc = _quantize_np(
        rng.normal(size=(n_blocks, bs, KH, DH)).astype(np.float32))
    tables = rng.permutation(np.arange(1, n_blocks))[:B * nb].reshape(
        B, nb).astype(np.int32)
    lengths = rng.integers(1, max_len + 1, size=B).astype(np.int32)
    lengths[0] = 1
    tables[0, 1:] = 0                       # unowned -> trash block 0
    q = rng.normal(size=(B, KH * g, DH)).astype(np.float32)
    return (q, k_pool, v_pool, tables, lengths), (k_sc, v_sc)


def _int8_decode_both(bs, g, window, oracle):
    arrays, (ksc, vsc) = _int8_decode_inputs(bs, g, seed=bs * 10 + g)
    got = ops.paged_decode_attention(
        *(torch.from_numpy(a) for a in arrays), window=window,
        k_scale=torch.from_numpy(ksc), v_scale=torch.from_numpy(vsc))
    want = oracle(*(jnp.asarray(a) for a in arrays), window=window,
                  k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bs,g,window", DECODE)
def test_int8_decode_plain_matches_reference(bs, g, window):
    _int8_decode_both(bs, g, window, jref_decode)


@pytest.mark.parametrize("bs,g,window", DECODE_PALLAS)
def test_int8_decode_plain_matches_pallas_interpret(bs, g, window):
    _int8_decode_both(bs, g, window, pallas_decode)


def test_int8_decode_ops_on_cpu_is_the_plain_version():
    arrays, (ksc, vsc) = _int8_decode_inputs(8, 2, seed=1)
    args = [torch.from_numpy(a) for a in arrays]
    sc = dict(k_scale=torch.from_numpy(ksc), v_scale=torch.from_numpy(vsc))
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.paged_decode_attention(*args, **sc),
                               ref.paged_decode_attention_ref(*args, **sc),
                               rtol=0, atol=0)
    assert set(ops.launch_counts().values()) == {0}
    assert cuda_decode.launches_int8 == 0
    with pytest.raises(ValueError, match="both or neither"):
        ref.paged_decode_attention_ref(*args, k_scale=sc["k_scale"])
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_decode(*args, **sc)


# ---------------------------------------------------------------------------
# the int8 engine against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    rc, c = _config()
    ref_p = ref_lm.init(jax.random.key(0), rc)
    p = params_from_numpy(jax.tree.map(np.asarray, ref_p), "cpu")
    rng = np.random.default_rng(5)
    shared = rng.integers(0, c.vocab, 32).astype(np.int32)
    reqs = []
    for i, (plen, budget) in enumerate([(5, 24), (20, 16), (40, 12),
                                        (9, 20), (14, 18)]):
        prompt = rng.integers(0, c.vocab, plen).astype(np.int32)
        if i % 2:                   # two full blocks shared with others
            prompt = np.concatenate([shared, prompt])
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=budget))
    return rc, c, ref_p, p, reqs


def _streams(out):
    return {r.rid: list(r.tokens) for r in out.results}


@pytest.fixture(scope="module")
def runs(setup):
    rc, c, ref_p, p, reqs = setup
    ref_reqs = [ref_requests.Request(**dataclasses.asdict(r)) for r in reqs]
    out = {}
    for sched, prefix in (("phased", False), ("chunked", True)):
        ref_eng = ref_engine.ServeEngine(
            rc, ref_p, n_slots=N_SLOTS, max_len=MAX_LEN, cache="paged",
            block_size=BS, kv_dtype="int8", prefix_cache=prefix)
        out["ref", sched] = ref_eng.serve(ref_reqs, sched=sched)
        for kv in ("fp32", "int8"):
            eng = ServeEngine(c, p, n_slots=N_SLOTS, max_len=MAX_LEN,
                              cache="paged", block_size=BS, kv_dtype=kv,
                              prefix_cache=prefix, device="cpu")
            out[kv, sched] = eng, eng.serve(reqs, sched=sched)
    return out


@pytest.mark.parametrize("sched", ["phased", "chunked"])
def test_int8_streams_agree_with_reference(runs, sched):
    want = runs["ref", sched]
    _, got = runs["int8", sched]
    assert stream_agreement(_streams(want), _streams(got)) >= 0.95
    assert (want.summary.n_requests, want.summary.n_tokens) == \
        (got.summary.n_requests, got.summary.n_tokens)
    assert sum(s.n_tokens for s in want.steps) == \
        sum(s.n_tokens for s in got.steps)


@pytest.mark.parametrize("sched", ["phased", "chunked"])
def test_int8_engine_completes_and_drains(runs, setup, sched):
    reqs = setup[-1]
    eng, out = runs["int8", sched]
    assert all(r.finish_reason == "length" for r in out.results)
    assert {r.rid: r.n_tokens for r in out.results} == \
        {r.rid: r.max_new_tokens for r in reqs}
    paged = eng._paged
    assert all(len(o) == 0 for o in paged._owned)
    assert paged.free_blocks + paged.reclaimable_blocks == paged.n_blocks - 1
    assert paged.pool_bytes < 0.55 * paged.pool_bytes_fp


@pytest.mark.parametrize("sched", ["phased", "chunked"])
def test_int8_vs_fp32_stream_agreement_is_recorded(runs, sched,
                                                   record_property):
    """Recorded, not gated: quantization noise may fork a greedy stream,
    and the reference misses its own 0.6 drill (ROADMAP Queue 3)."""
    _, fp = runs["fp32", sched]
    _, i8 = runs["int8", sched]
    agree = stream_agreement(_streams(fp), _streams(i8))
    record_property("fp32_vs_int8_stream_agreement", agree)
    assert 0.0 <= agree <= 1.0
    assert fp.summary.n_tokens == i8.summary.n_tokens


def test_int8_engine_hands_the_scales_to_both_paged_ops(setup, monkeypatch):
    """Every decode step and every paged prefill (prefix hits, chunks
    after the first) of an int8 engine reaches its op with the scales."""
    _, c, _, p, reqs = setup
    seen = {"decode": [], "prefill": []}
    real_d, real_p = ops.paged_decode_attention, ops.paged_prefill_attention

    def spy(kind, real):
        def fn(*args, **kwargs):
            seen[kind].append(kwargs.get("k_scale") is not None
                              and kwargs.get("v_scale") is not None)
            return real(*args, **kwargs)
        return fn

    monkeypatch.setattr(ops, "paged_decode_attention", spy("decode", real_d))
    monkeypatch.setattr(ops, "paged_prefill_attention",
                        spy("prefill", real_p))
    eng = ServeEngine(c, p, n_slots=N_SLOTS, max_len=MAX_LEN, cache="paged",
                      block_size=BS, kv_dtype="int8", prefix_cache=True,
                      device="cpu")
    eng.serve(reqs, sched="chunked")
    assert eng.paged_prefills > 0
    assert len(seen["prefill"]) == eng.paged_prefills * c.n_layers
    assert seen["decode"] and all(seen["decode"]) and all(seen["prefill"])
