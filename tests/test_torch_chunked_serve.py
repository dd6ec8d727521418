"""Chunked prefill, preemption and decode replay: ``repro_torch`` on the
CPU, against itself and against ``repro``.

Inside the port, the equalities of ``tests/test_chunked_serve.py`` hold
bit for bit (reduced fp32 llama3.2-3b, so greedy argmax never flakes on
bf16 ties): chunked streams equal phased streams with and without the
prefix cache; a pool that forces preemption completes where phased can
only defer, and the resumed streams equal the never-preempted ones;
replay keeps token accounting exact; a pinned prefix index still lets
eviction complete every request; admission preempts the younger running
slot; an unadmitted tail keeps FIFO.

Against the reference ``ServeEngine(cache="paged", sched="chunked")`` on
the same weights and requests: equal token counts, ``stream_agreement``
>= 0.95 (bit-identity across frameworks is not promised) and equal
preemption counts on the same forcing pool, fp32 and int8 pools.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.bench.workloads.serve import stream_agreement
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro.serve import requests as ref_requests
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.requests import Request, RequestResult
from repro_torch.serve.scheduler import Scheduler

torch.set_num_threads(1)

N_SLOTS, MAX_LEN, BS = 3, 96, 16


@pytest.fixture(scope="module")
def setup():
    kw = dict(dtype="float32", param_dtype="float32")
    rc = ref_get_config("llama3.2-3b").reduced(**kw)
    c = get_config("llama3.2-3b").reduced(**kw)
    ref_p = ref_lm.init(jax.random.key(0), rc)
    return rc, c, ref_p, params_from_numpy(jax.tree.map(np.asarray, ref_p),
                                           "cpu")


def _engine(setup, **kw):
    _, c, _, p = setup
    kw.setdefault("n_slots", N_SLOTS)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("block_size", BS)
    kw.setdefault("decode_window", 8)
    return ServeEngine(c, p, device="cpu", **kw)


def _ref_engine(setup, **kw):
    rc, _, ref_p, _ = setup
    kw.setdefault("n_slots", N_SLOTS)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("block_size", BS)
    kw.setdefault("decode_window", 8)
    return ref_engine.ServeEngine(rc, ref_p, cache="paged", **kw)


def _streams(out):
    return {r.rid: (r.tokens, r.finish_reason) for r in out.results}


def _mixed(c):
    rng = np.random.default_rng(11)
    shapes = [(5, 40), (20, 30), (40, 20), (64, 10)]
    return [Request(rid=i, prompt=rng.integers(0, c.vocab, p, np.int32),
                    max_new_tokens=b, arrival_s=0.0)
            for i, (p, b) in enumerate(shapes)]


def _oversubscribed(setup, **kw):
    """Two near-max requests against a 5-usable-block pool: worst-case
    demand is 3 + 3 blocks, so phased can only serve them serially while
    chunked admits both optimistically and preempts the younger when its
    decode growth overruns the pool."""
    c = setup[1]
    rng = np.random.default_rng(17)
    prompts = rng.integers(0, c.vocab, (2, 5), np.int32)
    reqs = [Request(rid=0, prompt=prompts[0], max_new_tokens=43),
            Request(rid=1, prompt=prompts[1], max_new_tokens=40)]
    eng = _engine(setup, n_slots=2, max_len=64, n_blocks=6, **kw)
    return eng, reqs


# ---------------------------------------------------------------------------
# inside the port: chunked == phased, bit for bit
# ---------------------------------------------------------------------------


def test_chunked_streams_match_phased_mixed_prompts(setup):
    """Prompts shorter than, equal to and spanning several chunks."""
    reqs = _mixed(setup[1])
    eng = _engine(setup)
    phased = eng.serve(list(reqs), sched="phased")
    chunked = eng.serve(list(reqs), sched="chunked")
    assert _streams(chunked) == _streams(phased)
    assert eng.preemptions == 0
    assert eng.paged_prefills > 0          # the 40- and 64-token prompts
    assert eng._paged.free_blocks == eng._paged.n_blocks - 1


def test_chunked_streams_match_phased_with_prefix_cache(setup):
    """Non-first chunks and prefix hits both run the suffix prefill; a
    late arrival sharing a three-block prefix hits the index."""
    c = setup[1]
    rng = np.random.default_rng(13)
    shared = rng.integers(0, c.vocab, 48, np.int32)
    tails = rng.integers(0, c.vocab, (2, 8), np.int32)
    reqs = [Request(rid=i, prompt=np.concatenate([shared, tails[i]]),
                    max_new_tokens=20) for i in range(2)]
    want = _streams(_engine(setup).serve(list(reqs), sched="phased"))
    pref = _engine(setup, prefix_cache=True)
    for mode in ("phased", "chunked"):
        pref.reset_prefix_cache()
        out0 = pref.serve([reqs[0]], sched=mode)
        out1 = pref.serve([reqs[1]], sched=mode)
        assert {**_streams(out0), **_streams(out1)} == want, mode
        assert pref.prefix_stats["hit_requests"] == 1, mode


# ---------------------------------------------------------------------------
# preemption and decode replay
# ---------------------------------------------------------------------------


def test_preemption_forcing_pool_completes_where_phased_defers(setup):
    eng, reqs = _oversubscribed(setup)
    phased = eng.serve(list(reqs), sched="phased")
    by_p = phased.by_rid()
    assert eng.preemptions == 0
    assert by_p[1].admitted_s >= by_p[0].finish_s

    chunked = eng.serve(list(reqs), sched="chunked")
    by_c = chunked.by_rid()
    assert eng.preemptions >= 1 and eng.replayed_tokens >= 1
    assert by_c[1].first_token_s < by_c[0].finish_s
    assert all(r.finish_reason == "length" for r in chunked.results)
    assert len(by_c[0].tokens) == 43 and len(by_c[1].tokens) == 40
    # the resumed stream equals the never-preempted one (decode replay)
    assert _streams(chunked) == _streams(phased)
    assert by_c[0].finish_s <= by_c[1].finish_s      # FIFO survives
    assert eng._paged.free_blocks == eng._paged.n_blocks - 1
    assert eng._slot_cap == {}


def test_replay_windows_keep_token_accounting_exact(setup):
    """Replay steps are credited energy but emit nothing, and replay
    forces per-token windows."""
    eng, reqs = _oversubscribed(setup)
    out = eng.serve(list(reqs), sched="chunked")
    assert eng.preemptions >= 1
    assert sum(s.n_tokens for s in out.steps) == \
        sum(r.n_tokens for r in out.results)
    for rec in out.steps:
        if rec.kind == "decode":
            assert rec.n_tokens <= len(rec.rids)
            assert len(rec.rids) % rec.n_steps == 0


def test_preemption_with_pinned_prefix_index_completes(setup):
    c = setup[1]
    rng = np.random.default_rng(19)
    prompts = rng.integers(0, c.vocab, (2, 16), np.int32)
    reqs = [Request(rid=0, prompt=prompts[0], max_new_tokens=32),
            Request(rid=1, prompt=prompts[1], max_new_tokens=32)]
    roomy = _engine(setup, n_slots=2, max_len=64, prefix_cache=True)
    want = _streams(roomy.serve(list(reqs), sched="phased"))
    tight = _engine(setup, n_slots=2, max_len=64, n_blocks=6,
                    prefix_cache=True)
    out = tight.serve(list(reqs), sched="chunked")
    assert tight.preemptions >= 1
    assert tight.prefix_stats["registered_blocks"] >= 1
    assert all(r.finish_reason == "length" for r in out.results)
    assert _streams(out) == want
    assert tight._paged.available_blocks == tight._paged.n_blocks - 1


def test_admission_preempts_younger_running_slot(setup):
    """A queue head older than a running slot reclaims that slot's blocks
    under the chunked scheduler; the victim re-queues at the front with
    its emitted history as a replay tail."""
    eng = _engine(setup, n_slots=2, max_len=64, n_blocks=5,
                  decode_window=1)
    eng._ensure_cache()
    sched = Scheduler(2, 64)
    young = Request(rid=1, prompt=np.zeros(5, np.int32),
                    max_new_tokens=40, arrival_s=1.0)
    sched.submit(young)
    (yslot,) = sched.refill(2.0)
    eng._slot_cap[yslot.index] = 1
    eng._paged.ensure(yslot.index, 33)          # 3 of 4 blocks
    yslot.prefill_pos = 5
    yslot.generated, yslot.pos, yslot.last_token = 7, 11, 6
    results = {0: RequestResult(rid=0, prompt_len=20),
               1: RequestResult(rid=1, prompt_len=5)}
    results[1].tokens = list(range(7))

    old = Request(rid=0, prompt=np.zeros(20, np.int32),
                  max_new_tokens=30, arrival_s=0.0)
    sched.submit(old)
    (oslot,) = sched.refill(2.0)
    ok = eng._admit_paged(sched, [oslot], results, chunked=True)

    assert ok == [oslot] and oslot.request is old
    assert eng.preemptions == 1
    assert eng._paged.owned(yslot.index) == 0
    assert eng._slot_cap == {oslot.index: 2}    # ceil(21 / 16)
    resume = sched.queue[0]
    assert resume.rid == 1 and resume.resumed
    assert resume.n_replay == 7 and resume.prompt_len == 5 + 7
    assert resume.max_new_tokens == 40 - 7
    assert [int(t) for t in resume.prompt[5:]] == list(range(7))


def test_unadmit_mid_chunked_prefill_preserves_fifo(setup):
    c = setup[1]
    rng = np.random.default_rng(23)
    reqs = [Request(rid=0, prompt=rng.integers(0, c.vocab, 64, np.int32),
                    max_new_tokens=15),
            Request(rid=1, prompt=rng.integers(0, c.vocab, 5, np.int32),
                    max_new_tokens=10),
            Request(rid=2, prompt=rng.integers(0, c.vocab, 5, np.int32),
                    max_new_tokens=10)]
    eng = _engine(setup, n_slots=3, max_len=80, n_blocks=7)
    phased = eng.serve(list(reqs), sched="phased")
    chunked = eng.serve(list(reqs), sched="chunked")
    assert _streams(chunked) == _streams(phased)
    by = chunked.by_rid()
    assert by[2].queue_s > 0                    # rid 2 was deferred
    assert by[0].admitted_s <= by[1].admitted_s <= by[2].admitted_s
    assert all(r.finish_reason == "length" for r in chunked.results)
    assert eng._paged.free_blocks == eng._paged.n_blocks - 1


def test_chunks_after_the_first_run_the_paged_prefill_op(setup,
                                                         monkeypatch):
    """A 64-token prompt in 16-token chunks: chunks 2-4 attend over the
    slot's own 1, 2 and 3 blocks through ``ops.paged_prefill_attention``
    (one call per layer and chunk)."""
    c = setup[1]
    widths = []
    real = ops.paged_prefill_attention

    def spy(*args, **kwargs):
        widths.append(args[5].shape[1])       # (B, npre) tables
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "paged_prefill_attention", spy)
    eng = _engine(setup, chunk_tokens=16)
    req = Request(rid=0, prompt=np.arange(64, dtype=np.int32) % c.vocab,
                  max_new_tokens=4)
    eng.serve([req], sched="chunked")
    assert eng.paged_prefills == 3
    assert widths == [w for w in (1, 2, 3) for _ in range(c.n_layers)]


@pytest.mark.parametrize("chunk_tokens", [0, 24])
def test_chunk_tokens_must_be_a_block_multiple(setup, chunk_tokens):
    eng = _engine(setup, chunk_tokens=chunk_tokens)
    req = Request(rid=0, prompt=np.zeros(8, np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="multiple of block_size"):
        eng.serve([req], sched="chunked")
    assert eng.serve([req], sched="phased").summary.n_tokens == 2


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_runs(setup):
    """Reference and port chunked runs: mixed prompts with the prefix
    cache (fp32), and the preemption-forcing pool (fp32 and int8)."""
    out = {}
    cases = [("mixed", "fp32", _mixed(setup[1]), dict(prefix_cache=True))]
    for kv in ("fp32", "int8"):
        _, reqs = _oversubscribed(setup)
        cases.append(("forcing", kv, reqs,
                      dict(n_slots=2, max_len=64, n_blocks=6)))
    for case, kv, reqs, kw in cases:
        ref_reqs = [ref_requests.Request(**dataclasses.asdict(r))
                    for r in reqs]
        ref_eng = _ref_engine(setup, kv_dtype=kv, **kw)
        ref_out = ref_eng.serve(ref_reqs, sched="chunked")
        eng = _engine(setup, kv_dtype=kv, **kw)
        out[case, kv] = (ref_eng, ref_out, eng,
                         eng.serve(list(reqs), sched="chunked"))
    return out


@pytest.mark.parametrize("case,kv", [("mixed", "fp32"), ("forcing", "fp32"),
                                     ("forcing", "int8")])
def test_chunked_streams_agree_with_reference(ref_runs, case, kv):
    _, want, _, got = ref_runs[case, kv]
    toks = lambda out: {r.rid: list(r.tokens) for r in out.results}
    assert stream_agreement(toks(want), toks(got)) >= 0.95
    assert (want.summary.n_requests, want.summary.n_tokens) == \
        (got.summary.n_requests, got.summary.n_tokens)
    assert sum(s.n_tokens for s in want.steps) == \
        sum(s.n_tokens for s in got.steps)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_preemption_counts_equal_reference(ref_runs, kv):
    ref_eng, _, eng, out = ref_runs["forcing", kv]
    assert eng.preemptions == ref_eng.preemptions >= 1
    assert all(r.finish_reason == "length" for r in out.results)
    assert eng._paged.free_blocks == eng._paged.n_blocks - 1
