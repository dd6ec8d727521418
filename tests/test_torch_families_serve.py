"""Serving the moe, ssm and hybrid families: the port's ``ServeEngine``
against the reference's, on the CPU.

Reduced fp32 granite-moe-3b-a800m, mamba2-1.3b, jamba-v0.1-52b (its
learned-position table cut to 1024 rows in both packages) and
llama4-maverick-400b-a17b, the reference's weights bridged, the same
requests (all arriving at once, so the schedule is the same in both
packages and both layouts):

  * the port's engine serves the reference engine's streams, paged and
    slotted: agreement 1.0, equal token counts and finish reasons. MoE
    streams are held to the reference's engine on the same schedule
    only: its capacity drops depend on every row of a call (pad rows,
    idle slots), so they are not gated across schedules;
  * inside the port, paged streams equal slotted ones;
  * the paged decode op runs once per attention layer and decode
    micro-step (none on mamba2), and the pool drains.

Stacks with mamba layers are covered further in
test_torch_families_state.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.bench.workloads.serve import stream_agreement
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro.serve import requests as ref_requests
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import blocks
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.requests import Request
from test_torch_families import ARCHS, configs

torch.set_num_threads(1)

N_SLOTS, MAX_LEN, BS = 3, 64, 16


def requests(vocab, n=6, seed=0):
    """Three prompt lengths, none a block multiple (stacks with mamba
    layers prefill each length as its own group: few lengths, few
    reference compiles)."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, (7, 12, 20)[i % 3])
                    .astype(np.int32), max_new_tokens=int(rng.integers(6, 16)))
            for i in range(n)]


def streams(out):
    return {r.rid: list(r.tokens) for r in out.results}


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    rc, c = configs(request.param)
    rp = ref_lm.init(jax.random.key(0), rc)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    reqs = requests(c.vocab)
    ref_reqs = [ref_requests.Request(**dataclasses.asdict(r)) for r in reqs]
    out = {"c": c, "reqs": reqs}
    for cache in ("paged", "slotted"):
        eng = ref_engine.ServeEngine(rc, rp, n_slots=N_SLOTS,
                                     max_len=MAX_LEN, cache=cache,
                                     block_size=BS)
        out["ref", cache] = eng.serve(ref_reqs, policy="continuous")
        eng = ServeEngine(c, p, n_slots=N_SLOTS, max_len=MAX_LEN,
                          cache=cache, block_size=BS, device="cpu")
        calls = []
        real = ops.paged_decode_attention

        def spy(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        ops.paged_decode_attention = spy
        try:
            out["port", cache] = eng.serve(reqs, policy="continuous")
        finally:
            ops.paged_decode_attention = real
        out["engine", cache] = eng
        out["decode_calls", cache] = len(calls)
    return out


@pytest.mark.parametrize("cache", ["paged", "slotted"])
def test_engine_matches_reference(served, cache):
    want, got = served["ref", cache], served["port", cache]
    assert stream_agreement(streams(want), streams(got)) == 1.0
    assert streams(got) == streams(want)
    assert (want.summary.n_requests, want.summary.n_tokens) == \
        (got.summary.n_requests, got.summary.n_tokens)
    assert {r.rid: r.finish_reason for r in want.results} == \
        {r.rid: r.finish_reason for r in got.results}


def test_paged_streams_equal_slotted(served):
    assert streams(served["port", "paged"]) == \
        streams(served["port", "slotted"])
    assert all(r.n_tokens == q.max_new_tokens for r, q in zip(
        sorted(served["port", "paged"].results, key=lambda r: r.rid),
        served["reqs"]))


def test_decode_op_runs_once_per_attention_layer_and_pool_drains(served):
    c = served["c"]
    out = served["port", "paged"]
    micro = sum(s.n_steps for s in out.steps if s.kind == "decode")
    assert micro > 0
    assert served["decode_calls", "paged"] == micro * blocks.attn_layers(c)
    assert served["decode_calls", "slotted"] == 0
    paged = served["engine", "paged"]._paged
    assert all(len(o) == 0 for o in paged._owned)
    assert paged.free_blocks == paged.n_blocks - 1
