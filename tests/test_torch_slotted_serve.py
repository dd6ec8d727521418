"""Slotted-cache parity: the port's dense KV rows against ``repro``'s.

The same numpy inputs (and bridged weights) go through the reference and
the port on the CPU, fp32 reduced configs:

  * the slotted cache ops (``grow_caches``, ``slotted_cache``,
    ``insert_slot``, ``reset_slot``, ``insert_rows`` with its pad rows
    dropped, ``compact_slots``) give the reference's trees exactly;
  * ``decode_attention``'s two dense branches — per-row positions (row
    scatter, (B, T) mask) and one shared position (slice write, window
    slice) — match at 1e-5 with and without a window, caches included;
    ``decode_step`` logits on slotted caches at 1e-4;
  * ``ServeEngine(cache="slotted")`` serves the reference's streams
    (agreement 1.0, equal token counts) under both policies, and inside
    the port slotted streams equal paged ones, fused or not (the
    reference's ``tests/test_paged_serve.py`` asserts the same of
    itself);
  * the reference's refusals hold as ``ValueError``: the prefix cache,
    int8 pools and the chunked scheduler need the paged cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench.workloads.serve import stream_agreement
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import lm as ref_lm
from repro.serve import cache as ref_cache
from repro.serve import engine as ref_engine
from repro.serve import requests as ref_requests
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import attention, blocks, lm
from repro_torch.serve import cache
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.requests import poisson_requests

torch.set_num_threads(1)

OP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
N_SLOTS, MAX_LEN, BS = 4, 64, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=OP_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    kw = dict(dtype="float32", param_dtype="float32")
    ref_c = ref_get_config("llama3.2-3b").reduced(**kw)
    c = get_config("llama3.2-3b").reduced(**kw)
    ref_p = ref_lm.init(jax.random.key(0), ref_c)
    p = params_from_numpy(_tree_np(ref_p), "cpu")
    return ref_c, c, ref_p, p


def _pool(rng, n_slots=3, t=8, layers=2, kh=2, dh=4):
    return {"slot0": {n: rng.normal(size=(layers, n_slots, t, kh, dh))
                      .astype(np.float32) for n in ("k", "v")}}


def _torch_tree(tree):
    return {"slot0": {n: _t(v) for n, v in tree["slot0"].items()}}


def _same_tree(got, want):
    for name, leaf in want["slot0"].items():
        np.testing.assert_array_equal(got["slot0"][name].numpy(),
                                      np.asarray(leaf))


def test_slotted_cache_matches_reference(setup):
    ref_c, c, ref_p, _ = setup
    want = ref_cache.slotted_cache(ref_c, N_SLOTS, MAX_LEN, ref_p)
    got = cache.slotted_cache(c, N_SLOTS, MAX_LEN, device=torch.device("cpu"))
    assert set(got["slot0"]) == set(want["slot0"])
    for name, leaf in want["slot0"].items():
        assert tuple(got["slot0"][name].shape) == leaf.shape
        assert str(got["slot0"][name].dtype).endswith(str(leaf.dtype))
    _same_tree(got, want)


def test_grow_caches_matches_reference():
    rows = _pool(np.random.default_rng(0), t=5)
    want = ref_cache.grow_caches(jax.tree.map(jnp.asarray, rows), 12)
    got = cache.grow_caches(_torch_tree(rows), 12)
    _same_tree(got, want)
    with pytest.raises(ValueError, match="max_len"):
        cache.grow_caches(_torch_tree(rows), 4)


@pytest.mark.parametrize("slot", [0, 2])
def test_insert_and_reset_slot_match_reference(slot):
    rng = np.random.default_rng(1)
    big, row = _pool(rng), _pool(rng, n_slots=1)
    want = ref_cache.insert_slot(jax.tree.map(jnp.asarray, big),
                                 jax.tree.map(jnp.asarray, row),
                                 jnp.int32(slot))
    got = cache.insert_slot(_torch_tree(big), _torch_tree(row), slot)
    _same_tree(got, want)
    want = ref_cache.reset_slot(want, jnp.int32(slot))
    _same_tree(cache.reset_slot(got, slot), want)


@pytest.mark.parametrize("slots", [[2, 0], [1, 3], [3, 3], [3, 5]])
def test_insert_rows_drops_out_of_range_slots_as_reference(slots):
    """Rows fill positions [0, S) of their slots; ids >= n_slots (the pad
    rows of a batched prefill) are dropped, not an error."""
    rng = np.random.default_rng(2)
    big, rows = _pool(rng), _pool(rng, n_slots=2, t=5)
    want = ref_cache.insert_rows(jax.tree.map(jnp.asarray, big),
                                 jax.tree.map(jnp.asarray, rows),
                                 jnp.asarray(slots, jnp.int32))
    got = cache.insert_rows(_torch_tree(big), _torch_tree(rows), slots)
    _same_tree(got, want)


def test_compact_slots_matches_reference():
    rng = np.random.default_rng(3)
    big = _pool(rng)
    perm = np.array([2, 0, 0], np.int32)
    want = ref_cache.compact_slots(jax.tree.map(jnp.asarray, big),
                                   jnp.asarray(perm))
    _same_tree(cache.compact_slots(_torch_tree(big), perm), want)


def _attn_layer(setup, window):
    ref_c, c, ref_p, p = setup
    ref_c = dataclasses.replace(ref_c, attn_window=window)
    c = dataclasses.replace(c, attn_window=window)
    ref_a = jax.tree.map(lambda a: a[0], ref_p["layers"]["slot0"]["attn"])
    a = blocks.layer(p["layers"]["slot0"]["attn"], 0)
    return ref_c, c, ref_a, a


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("per_row", [True, False])
def test_dense_decode_attention_matches_reference(setup, window, per_row):
    ref_c, c, ref_a, a = _attn_layer(setup, window)
    rng = np.random.default_rng(4)
    b, t = 3, 12
    x = rng.normal(size=(b, 1, c.d_model)).astype(np.float32)
    kv = {n: rng.normal(size=(b, t, c.n_kv_heads, c.d_head))
          .astype(np.float32) for n in ("k", "v")}
    pos = np.array([0, 4, 11], np.int32) if per_row else np.int32(9)
    want, wk, wv = ref_attn.decode_attention(
        ref_c, ref_a, jnp.asarray(x), jnp.asarray(kv["k"]),
        jnp.asarray(kv["v"]), jnp.asarray(pos))
    ck, cv = _t(kv["k"]), _t(kv["v"])
    got = attention.decode_attention(
        c, a, _t(x), ck, cv, _t(pos) if per_row else int(pos))
    _close(got, want)
    _close(ck, wk)
    _close(cv, wv)


def test_decode_step_logits_on_slotted_caches(setup):
    """Prefill into a slotted pool (insert_rows), then decode steps with
    per-row positions and one with a shared position, against the
    reference step by step."""
    ref_c, c, ref_p, p = setup
    rng = np.random.default_rng(5)
    b, s = 2, 8
    lens = np.array([5, 8], np.int32)
    tok = rng.integers(0, c.vocab, size=(b, s)).astype(np.int32)
    want, jrows, _ = ref_lm.prefill(ref_c, ref_p, jnp.asarray(tok),
                                    last_pos=jnp.asarray(lens - 1))
    got, rows, _ = lm.prefill(c, p, _t(tok), last_pos=_t(lens - 1))
    _close(got, want, LOGIT_TOL)
    slots = np.array([2, 0], np.int32)
    jpool = ref_cache.insert_rows(
        ref_cache.slotted_cache(ref_c, 3, 16, ref_p), jrows,
        jnp.asarray(slots))
    tpool = cache.insert_rows(
        cache.slotted_cache(c, 3, 16, device=torch.device("cpu")), rows, slots)
    pos = np.full(3, 15, np.int32)               # idle slot 1 parks at T-1
    pos[slots] = lens
    nxt = np.zeros((3, 1), np.int32)
    nxt[slots, 0] = np.asarray(jnp.argmax(want[:, -1], -1))
    for _ in range(3):
        want, jpool = ref_lm.decode_step(ref_c, ref_p, jnp.asarray(nxt),
                                         jpool, jnp.asarray(pos))
        got, tpool = lm.decode_step(c, p, _t(nxt), tpool, _t(pos))
        _close(got, want, LOGIT_TOL)
        nxt = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)[:, None]
        pos[slots] += 1
    want, jpool = ref_lm.decode_step(ref_c, ref_p, jnp.asarray(nxt), jpool,
                                     jnp.int32(9))
    got, tpool = lm.decode_step(c, p, _t(nxt), tpool, 9)
    _close(got, want, LOGIT_TOL)
    for name in ("k", "v"):
        _close(tpool["slot0"][name], jpool["slot0"][name], LOGIT_TOL)


def _requests(vocab):
    return poisson_requests(12, 400.0, vocab, prompt_len=8, seed=3,
                            short=(2, 8), long=(30, 50))


def _streams(out):
    return {r.rid: list(r.tokens) for r in out.results}


@pytest.fixture(scope="module")
def served(setup):
    """Arrivals kept (12 requests at 400 Hz): admission waves follow the
    clock, which moves the schedule but no greedy stream."""
    ref_c, c, ref_p, p = setup
    reqs = _requests(c.vocab)
    ref_reqs = [ref_requests.Request(**dataclasses.asdict(r)) for r in reqs]
    out = {}
    for policy in ("continuous", "fixed"):
        eng = ref_engine.ServeEngine(ref_c, ref_p, n_slots=N_SLOTS,
                                     max_len=MAX_LEN, cache="slotted",
                                     block_size=BS)
        out["ref", policy] = eng.serve(ref_reqs, policy=policy)
        for kind in ("slotted", "paged"):
            for window in (1, 8):
                eng = ServeEngine(c, p, n_slots=N_SLOTS, max_len=MAX_LEN,
                                  cache=kind, block_size=BS,
                                  decode_window=window, device="cpu")
                out[kind, policy, window] = eng.serve(reqs, policy=policy)
    return out


@pytest.mark.parametrize("policy", ["continuous", "fixed"])
def test_slotted_engine_matches_reference(served, policy):
    ref_out = served["ref", policy]
    out = served["slotted", policy, 8]
    assert stream_agreement(_streams(ref_out), _streams(out)) == 1.0
    assert (ref_out.summary.n_requests, ref_out.summary.n_tokens) == \
        (out.summary.n_requests, out.summary.n_tokens)
    assert {r.rid: r.finish_reason for r in ref_out.results} == \
        {r.rid: r.finish_reason for r in out.results}


@pytest.mark.parametrize("policy", ["continuous", "fixed"])
def test_slotted_streams_equal_paged_streams(served, policy):
    want = _streams(served["slotted", policy, 1])
    for kind in ("slotted", "paged"):
        for window in (1, 8):
            assert _streams(served[kind, policy, window]) == want, \
                (kind, window)


def test_slotted_engine_decodes_through_no_kernel_op(setup, monkeypatch):
    """A slotted cache attends through ``sdpa``: the paged ops never run
    (as in the reference, where no Pallas kernel carries it)."""
    _, c, _, p = setup
    from repro_torch.kernels import ops

    def refuse(*args, **kwargs):
        raise AssertionError("a paged kernel op ran on a slotted cache")

    monkeypatch.setattr(ops, "paged_decode_attention", refuse)
    monkeypatch.setattr(ops, "paged_prefill_attention", refuse)
    eng = ServeEngine(c, p, n_slots=2, max_len=32, cache="slotted",
                      block_size=BS, device="cpu")
    out = eng.serve(_requests(c.vocab)[:3])
    assert out.summary.n_tokens == sum(
        r.max_new_tokens for r in _requests(c.vocab)[:3])


@pytest.mark.parametrize("kw,match", [
    (dict(prefix_cache=True), "prefix"),
    (dict(kv_dtype="int8"), "int8"),
    (dict(cache="dense"), "slotted or paged"),
])
def test_slotted_refusals_are_value_errors(setup, kw, match):
    _, c, _, p = setup
    kw = {"cache": "slotted", **kw}
    with pytest.raises(ValueError, match=match):
        ServeEngine(c, p, device="cpu", **kw)


def test_chunked_serve_and_warmup_need_paged(setup):
    _, c, _, p = setup
    eng = ServeEngine(c, p, n_slots=2, max_len=32, cache="slotted",
                      block_size=BS, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        eng.serve(_requests(c.vocab)[:2], sched="chunked")
    with pytest.raises(ValueError, match="paged"):
        eng.warmup(sched="chunked")
    eng.warmup(sched="phased")


def test_warmup_takes_the_measured_scheduler(setup, monkeypatch):
    """``warmup(sched=...)`` serves under that scheduler (serve_slo warms
    each cell under its own)."""
    _, c, _, p = setup
    eng = ServeEngine(c, p, n_slots=2, max_len=32, cache="paged",
                      block_size=BS, n_blocks=5, device="cpu")
    seen = []
    serve = eng.serve

    def spy(requests, **kw):
        seen.append(kw.get("sched"))
        return serve(requests, **kw)

    monkeypatch.setattr(eng, "serve", spy)
    eng.warmup(requests=_requests(c.vocab)[:3], sched="chunked")
    eng.warmup(requests=_requests(c.vocab)[:3])
    assert seen == ["chunked", None]
