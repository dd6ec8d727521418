"""Per-slot state rows of the mamba families in the port's caches and
engine, against the reference, on the CPU.

  * the cache trees: the port's slotted cache and ``PagedKVCache`` for
    mamba2 and jamba have the reference's leaves, shapes and dtypes
    (attention slots pooled, mamba slots ``{"ssm", "conv"}`` per-slot
    rows, fp32 state even in a bf16 model), and its capacity arithmetic
    (a pure-SSM stack: no pool bytes, ``max_concurrency == n_slots``);
  * the slot ops on state rows (``insert_slot``, ``reset_slot``,
    ``insert_rows``, ``compact_slots``, ``insert_paged_prefill`` by slot
    id with pad ids dropped, ``copy_blocks`` leaving them alone) give the
    reference's trees;
  * the twins of ``tests/test_paged_serve.py``'s
    ``test_ssm_family_batched_prefill_keeps_exact_state`` and
    ``test_paged_matches_slotted_for_ssm_hybrid_stack``, for mamba2 and
    for jamba;
  * a jamba engine on int8 pools serves the reference int8 engine's
    streams (>= 0.95, equal token counts, as tests/test_torch_int8_kv.py
    holds the dense family) and drains;
  * the prefix cache and the chunked scheduler are refused for ssm and
    hybrid stacks (ValueError), as the reference refuses them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench.workloads.serve import stream_agreement
from repro.models import lm as ref_lm
from repro.serve import cache as ref_cache
from repro.serve import engine as ref_engine
from repro.serve import requests as ref_requests
from repro_torch.bridge import params_from_numpy
from repro_torch.models import lm
from repro_torch.serve import cache
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.requests import Request
from test_torch_families import configs

torch.set_num_threads(1)

RECURRENT = ["mamba2-1.3b", "jamba-v0.1-52b"]
CPU = torch.device("cpu")
PROMPT = 5


def _leaves(t, prefix=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, t


def _same(got, want):
    want = dict(_leaves(want))
    got = dict(_leaves(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).endswith(w.dtype.name), (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      w.astype(np.float32), err_msg=str(path))


@pytest.fixture(scope="module", params=RECURRENT)
def models(request):
    rc, c = configs(request.param)
    rp = ref_lm.init(jax.random.key(1), rc)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rc, c, rp, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_cache_trees_match_reference(arch, dtype):
    rc, c = configs(arch, dtype=dtype, param_dtype=dtype)
    abstract = ref_lm.init_abstract(rc)
    _same(cache.slotted_cache(c, 3, 64, device=CPU),
          ref_cache.slotted_cache(rc, 3, 64, abstract))
    for kv in ("fp32", "int8"):
        want = ref_cache.PagedKVCache(rc, 3, 64, abstract, block_size=16,
                                      kv_dtype=kv)
        got = cache.PagedKVCache(c, 3, 64, block_size=16, kv_dtype=kv,
                                 device=CPU)
        _same(got.caches, want.caches)
        assert (got.pool_bytes, got.pool_bytes_fp, got.bytes_per_block,
                got.max_concurrency) == (
            want.pool_bytes, want.pool_bytes_fp, want.bytes_per_block,
            want.max_concurrency), kv
        for slot, tree in got.caches.items():
            if "ssm" in tree:
                assert tree["ssm"].dtype == torch.float32
                assert tree["ssm"].shape[1] == 3        # per-slot rows
    if c.family == "ssm":
        assert got.pool_bytes == got.bytes_per_block == 0
        assert got.max_concurrency == 3


def _random_tree(rng, like, batch=None):
    """numpy leaves shaped like ``like``'s (batch axis 1 replaced)."""
    out = {}
    for slot, tree in like.items():
        out[slot] = {}
        for name, leaf in tree.items():
            shape = list(leaf.shape)
            if batch is not None:
                shape[1] = batch
            if name in ("k", "v") and batch is not None:
                shape[2] = 5
            out[slot][name] = rng.normal(size=shape).astype(np.float32)
    return out


def _port(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _ref(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_slot_ops_on_state_rows_match_reference():
    rc, c = configs("jamba-v0.1-52b")
    rng = np.random.default_rng(2)
    big = _random_tree(rng, cache.slotted_cache(c, 3, 8, device=CPU))
    row = _random_tree(rng, big, batch=1)
    want = ref_cache.insert_slot(_ref(big), _ref(row), jnp.int32(2))
    got = cache.insert_slot(_port(big), _port(row), 2)
    _same(got, want)
    _same(cache.reset_slot(got, 1), ref_cache.reset_slot(want, jnp.int32(1)))
    rows = _random_tree(rng, big, batch=2)
    for slots in ([2, 0], [1, 3]):              # 3: a pad row, dropped
        want = ref_cache.insert_rows(_ref(big), _ref(rows),
                                     jnp.asarray(slots, jnp.int32))
        _same(cache.insert_rows(_port(big), _port(rows), slots), want)
    perm = np.array([2, 0, 0], np.int32)
    _same(cache.compact_slots(_port(big), perm),
          ref_cache.compact_slots(_ref(big), jnp.asarray(perm)))


def test_paged_insert_writes_state_by_slot_and_copy_leaves_it():
    rc, c = configs("jamba-v0.1-52b")
    rng = np.random.default_rng(3)
    paged = cache.PagedKVCache(c, 3, 32, block_size=4, n_blocks=9,
                               device=CPU)
    big = _random_tree(rng, paged.caches)
    rows = _random_tree(rng, big, batch=2)
    for slot in rows.values():
        for name in ("k", "v"):
            if name in slot:
                slot[name] = slot[name][:, :, :5]
    blocks = np.array([[3, 7], [9, 9]])         # row 1 is a pad row
    slots = np.array([1, 3])
    with jax.disable_jit():
        want = ref_cache.insert_paged_prefill(
            _ref(big), _ref(rows), jnp.asarray(blocks, jnp.int32),
            jnp.asarray(slots, jnp.int32), block_size=4)
    got = cache.insert_paged_prefill(_port(big), _port(rows), blocks, slots,
                                     block_size=4)
    _same(got, want)
    with pytest.raises(ValueError, match="slots"):
        cache.insert_paged_prefill(_port(big), _port(rows), blocks,
                                   block_size=4)
    before = _port(big)
    after = cache.copy_blocks(_port(big), [1], [2])
    for slot, tree in after.items():
        for name, leaf in tree.items():
            if name in ("ssm", "conv"):
                assert torch.equal(leaf, before[slot][name])
            else:
                assert torch.equal(leaf[:, 2], before[slot][name][:, 1])


def test_batched_prefill_keeps_exact_state(models):
    """Twin of the reference's test: the engine's stream equals a manual
    unpadded prefill and decode chain (mamba layers must prefill at the
    exact prompt length)."""
    _rc, c, _rp, p = models
    prompt = np.random.default_rng(5).integers(0, c.vocab, PROMPT).astype(
        np.int32)
    budget = 6
    logits, caches, _ = lm.prefill(c, p, torch.from_numpy(prompt[None]))
    caches = cache.grow_caches(caches, 32)
    want = [int(logits[0, -1].argmax())]
    pos = PROMPT
    with torch.no_grad():
        for _ in range(budget - 1):
            tok = torch.tensor([[want[-1]]])
            logits, caches = lm.decode_step(c, p, tok, caches, pos)
            want.append(int(logits[0, -1].argmax()))
            pos += 1
    eng = ServeEngine(c, p, n_slots=2, max_len=32, cache="slotted",
                      decode_window=4, device="cpu")
    out = eng.serve([Request(rid=0, prompt=prompt, max_new_tokens=budget)])
    assert out.by_rid()[0].tokens == want


def test_paged_matches_slotted_for_ssm_hybrid_stack(models):
    """Twin of the reference's test: exact-length prefill, attention KV
    paged into the shared pool, per-slot state rows beside it; the
    streams equal the slotted cache's (and the reference's)."""
    rc, c, rp, p = models
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, c.vocab, PROMPT).astype(
        np.int32), max_new_tokens=6) for i in range(3)]

    def run(kind):
        eng = ServeEngine(c, p, n_slots=2, max_len=32, cache=kind,
                          block_size=16, decode_window=4, device="cpu")
        return {r.rid: r.tokens for r in eng.serve(list(reqs)).results}

    paged = run("paged")
    assert paged == run("slotted")
    eng = ref_engine.ServeEngine(rc, rp, n_slots=2, max_len=32,
                                 cache="paged", block_size=16,
                                 decode_window=4)
    out = eng.serve([ref_requests.Request(**dataclasses.asdict(r))
                     for r in reqs], policy="continuous")
    assert {r.rid: r.tokens for r in out.results} == paged


def test_hybrid_on_int8_pools_matches_reference():
    rc, c = configs("jamba-v0.1-52b")
    rp = ref_lm.init(jax.random.key(1), rc)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    rng = np.random.default_rng(9)
    reqs = [Request(rid=i, prompt=rng.integers(0, c.vocab, (9, 21)[i % 2])
                    .astype(np.int32), max_new_tokens=int(rng.integers(8, 20)))
            for i in range(5)]
    want = ref_engine.ServeEngine(rc, rp, n_slots=3, max_len=64,
                                  cache="paged", block_size=16,
                                  kv_dtype="int8").serve(
        [ref_requests.Request(**dataclasses.asdict(r)) for r in reqs],
        policy="continuous")
    eng = ServeEngine(c, p, n_slots=3, max_len=64, cache="paged",
                      block_size=16, kv_dtype="int8", device="cpu")
    got = eng.serve(reqs)
    streams = lambda o: {r.rid: list(r.tokens) for r in o.results}
    assert stream_agreement(streams(want), streams(got)) >= 0.95
    assert (want.summary.n_requests, want.summary.n_tokens) == \
        (got.summary.n_requests, got.summary.n_tokens)
    paged = eng._paged
    assert all(len(o) == 0 for o in paged._owned)
    assert paged.free_blocks == paged.n_blocks - 1
    assert paged.pool_bytes < 0.55 * paged.pool_bytes_fp


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefix_cache_and_chunked_prefill_are_refused(arch):
    _rc, c = configs(arch)
    p = lm.init(c, torch.Generator().manual_seed(0), "cpu")
    for kw in (dict(prefix_cache=True), dict(sched="chunked")):
        with pytest.raises(ValueError, match="mamba layers"):
            ServeEngine(c, p, max_len=64, cache="paged", device="cpu", **kw)
    eng = ServeEngine(c, p, n_slots=2, max_len=64, cache="paged",
                      device="cpu")
    req = [Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                   max_new_tokens=2)]
    with pytest.raises(ValueError, match="mamba layers"):
        eng.serve(req, sched="chunked")
    eng.warmup()
    assert eng.serve(req).summary.n_tokens == 2
