"""Serve-path parity: ``repro_torch.serve`` against ``repro.serve``.

One seeded request list (the port's ``poisson_requests``, half of the
prompts behind a shared two-block system prefix) goes through the
reference ``ServeEngine(cache="paged", paged_impl="xla")`` and through
the port's engine on the CPU, with the prefix cache off and on.

  * across frameworks, per-rid greedy streams agree (``stream_agreement``
    >= 0.95; bit-identity across frameworks is not promised) and the
    summary token counts are equal;
  * inside the port, prefix-hit streams equal cold streams and fused
    decode windows equal per-token decode, bit for bit;
  * the pool drains clean, and the pad rows of a batched prefill are
    dropped (not written, not an error).

The int8 pool, the chunked scheduler, the slotted cache, fixed-batch
``generate`` and the degradation paths have their own files
(``test_torch_int8_kv.py``, ``test_torch_chunked_serve.py``,
``test_torch_slotted_serve.py``, ``test_torch_generate.py``,
``test_torch_serve_degrade.py``).
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
from repro_torch.launch import serve as serve_cli
from repro_torch.power.methods import NvmlPower, SyntheticPower
from repro_torch.serve import cache as cache_lib
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.requests import poisson_requests

torch.set_num_threads(1)

N_SLOTS, MAX_LEN, BS = 4, 64, 8
PREFIX = 16      # two full blocks shared by half of the prompts


def _requests(vocab, n=10, seed=3):
    """Seeded requests; arrivals zeroed so admission waves do not depend
    on wall-clock timing."""
    rng = np.random.default_rng(seed)
    base = poisson_requests(n, 100.0, vocab, prompt_len=12, seed=seed,
                            short=(3, 8), long=(10, 14), p_long=0.3)
    shared = rng.integers(0, vocab, size=PREFIX).astype(np.int32)
    out = []
    for r in base:
        prompt = r.prompt[:int(rng.integers(3, 13))]
        if r.rid % 2 == 0:
            prompt = np.concatenate([shared, prompt])
        out.append(dataclasses.replace(r, prompt=prompt.astype(np.int32),
                                       arrival_s=0.0))
    return out


@pytest.fixture(scope="module")
def setup():
    arch = "llama3.2-3b"
    kw = dict(dtype="float32", param_dtype="float32")
    ref_c = ref_get_config(arch).reduced(**kw)
    c = get_config(arch).reduced(**kw)
    ref_p = ref_lm.init(jax.random.key(0), ref_c)
    p = params_from_numpy(jax.tree.map(np.asarray, ref_p), "cpu")
    return ref_c, c, ref_p, p, _requests(c.vocab)


def _port_run(setup, prefix, window=8, policy="continuous", power=(),
              n_blocks=None):
    _, c, _, p, reqs = setup
    eng = ServeEngine(c, p, n_slots=N_SLOTS, max_len=MAX_LEN,
                      cache="paged", block_size=BS, prefix_cache=prefix,
                      decode_window=window, device="cpu",
                      power_methods=power, n_blocks=n_blocks)
    return eng, eng.serve(reqs, policy=policy)


@pytest.fixture(scope="module")
def runs(setup):
    """Reference and port runs, prefix cache off and on."""
    ref_c, _, ref_p, _, reqs = setup
    ref_reqs = [ref_requests.Request(**dataclasses.asdict(r)) for r in reqs]
    out = {}
    for prefix in (False, True):
        eng = ref_engine.ServeEngine(
            ref_c, ref_p, n_slots=N_SLOTS, max_len=MAX_LEN, cache="paged",
            block_size=BS, prefix_cache=prefix, paged_impl="xla")
        out["ref", prefix] = eng.serve(ref_reqs, policy="continuous")
        out["port", prefix] = _port_run(setup, prefix)
    return out


def _streams(res):
    return {r.rid: list(r.tokens) for r in res.results}


@pytest.mark.parametrize("prefix", [False, True])
def test_streams_agree_with_reference(runs, prefix):
    ref_out = runs["ref", prefix]
    _, out = runs["port", prefix]
    assert stream_agreement(_streams(ref_out), _streams(out)) >= 0.95
    for a, b in ((ref_out.summary, out.summary),):
        assert (a.n_requests, a.n_tokens) == (b.n_requests, b.n_tokens)
    assert sum(r.prompt_len for r in ref_out.results) \
        == sum(r.prompt_len for r in out.results)
    assert sum(s.n_tokens for s in ref_out.steps) \
        == sum(s.n_tokens for s in out.steps)


def test_prefix_hits_bit_identical_to_cold(runs):
    eng, hit = runs["port", True]
    _, cold = runs["port", False]
    assert eng.prefix_stats["hit_requests"] > 0
    assert eng.prefix_stats["reused_blocks"] >= 2 * \
        eng.prefix_stats["hit_requests"]
    assert _streams(hit) == _streams(cold)


def test_prefix_hits_run_the_paged_prefill_op(setup, monkeypatch):
    calls = []
    real = ops.paged_prefill_attention

    def spy(*args, **kwargs):
        calls.append(args[5].shape)      # the (B, npre) prefix tables
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "paged_prefill_attention", spy)
    eng, _ = _port_run(setup, prefix=True)
    assert eng.prefix_stats["hit_requests"] > 0
    assert calls and all(shape[1] >= PREFIX // BS for shape in calls)


def test_fused_windows_bit_identical_to_per_token(setup, runs):
    _, fused = runs["port", False]
    _, unfused = _port_run(setup, prefix=False, window=1)
    assert any(s.n_steps > 1 for s in fused.steps)
    assert _streams(fused) == _streams(unfused)


def test_fixed_policy_same_streams(setup, runs):
    _, cont = runs["port", False]
    _, fixed = _port_run(setup, prefix=False, policy="fixed")
    assert _streams(fixed) == _streams(cont)


def test_oversubscribed_pool_defers_instead_of_failing(setup, runs):
    """A pool of one full slot (the least allowed) cannot reserve every
    admission's worst case: admission defers the queue head (FIFO) until
    blocks free up, and the streams stay those of a roomy pool."""
    _, roomy = runs["port", False]
    eng, tight = _port_run(setup, prefix=False,
                           n_blocks=1 + MAX_LEN // BS)
    assert all(r.finish_reason == "length" for r in tight.results)
    assert _streams(tight) == _streams(roomy)
    assert _max_live(roomy) == N_SLOTS
    assert _max_live(tight) < N_SLOTS      # admission had to defer
    assert eng._paged.free_blocks == eng._paged.n_blocks - 1


def _max_live(out):
    return max(sum(r.admitted_s <= a.admitted_s < r.finish_s
                   for r in out.results) for a in out.results)


@pytest.mark.parametrize("prefix", [False, True])
def test_pool_drains_clean(runs, prefix):
    eng, out = runs["port", prefix]
    paged = eng._paged
    assert all(r.finish_reason == "length" for r in out.results)
    assert all(len(o) == 0 for o in paged._owned)
    assert paged.free_blocks + paged.reclaimable_blocks == paged.n_blocks - 1
    eng.reset_prefix_cache()
    assert paged.free_blocks == paged.n_blocks - 1


def test_energy_attribution_with_power(setup):
    _, out = _port_run(setup, prefix=False, power=[SyntheticPower()])
    s = out.summary
    assert s.attributed_wh > 0 and s.wh_per_token > 0
    assert abs(s.attributed_wh - sum(r.energy_wh for r in out.results)) < 1e-12


def test_insert_drops_pad_rows():
    """JAX's scatter drops out-of-range ids (mode="drop") and the engine
    pads its batched prefill with block id n_blocks. The port masks them."""
    n_blocks, bs = 6, 4
    pool = torch.full((1, n_blocks, bs, 1, 2), -1.0)
    caches = {"slot0": {"k": pool.clone(), "v": pool.clone()}}
    rows = {"slot0": {n: torch.arange(1 * 3 * 6 * 2, dtype=torch.float32)
                      .reshape(1, 3, 6, 1, 2) for n in ("k", "v")}}
    blocks = np.array([[2, 5], [1, n_blocks], [n_blocks, n_blocks]])
    with pytest.raises(IndexError):        # what an unmasked scatter does
        pool[:, torch.as_tensor(blocks.reshape(-1))] = 0.0
    cache_lib.insert_paged_prefill(caches, rows, blocks, block_size=bs)
    k = caches["slot0"]["k"]
    src = rows["slot0"]["k"]
    torch.testing.assert_close(k[0, 2, :, 0], src[0, 0, 0:4, 0])
    torch.testing.assert_close(k[0, 5, :2, 0], src[0, 0, 4:6, 0])
    assert (k[0, 5, 2:] == 0).all()        # zero-padded partial block
    torch.testing.assert_close(k[0, 1, :, 0], src[0, 1, 0:4, 0])
    for untouched in (0, 3, 4):            # trash block + never-named ones
        assert (k[0, untouched] == -1.0).all()


def test_copy_blocks_in_place():
    caches = {"slot0": {"k": torch.arange(2 * 4 * 2, dtype=torch.float32)
                        .reshape(2, 4, 2), "v": torch.zeros(2, 4, 2)}}
    want = caches["slot0"]["k"][:, 1].clone()
    cache_lib.copy_blocks(caches, [1], [3])
    torch.testing.assert_close(caches["slot0"]["k"][:, 3], want)


def test_nvml_power_raises_without_library(tmp_path):
    """A measured backend never substitutes a synthetic reading."""
    with pytest.raises(RuntimeError, match="cannot be opened"):
        NvmlPower(lib_path=str(tmp_path / "libnvidia-ml.so.1"))


def test_cli_tiny_on_cpu(capsys):
    out = serve_cli.main(["--arch", "llama3.2-3b", "--preset", "tiny",
                          "--device", "cpu", "--mode", "continuous",
                          "--cache", "paged", "--requests", "4", "--slots", "2",
                          "--prompt-len", "8", "--gen", "4",
                          "--prefix-cache"])
    assert out.summary.n_requests == 4
    assert "power=synthetic" in capsys.readouterr().out
