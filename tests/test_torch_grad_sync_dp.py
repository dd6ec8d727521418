"""The port's data-parallel step across ranks against ``repro``'s, on
the CPU.

The reference runs its dp steps on forced host devices in a subprocess
(as ``tests/conftest.py::run_in_subprocess`` runs it), from its own
seeded weights, and pickles its weights, batches and results; the port
runs the same steps in gloo ranks (``launch.mesh.spawn``, a ``FileStore``
rendezvous, a timeout on every group) from those weights, bridged. On
the reduced fp32 gpt-117m, three steps of ``make_dp_train_step`` on a
global batch of 8 x 16 tokens:

  * dp2 and dp4, fp32 buckets, overlap on and off: losses at rtol 1e-5,
    params and the gathered AdamW state at rtol 1e-4 (atol 1e-6);
  * dp2 int8 buckets: each rank's error-feedback state against the
    reference's row; an entry whose code the two packages round to
    neighbouring values shows as a residual one quantization step apart
    (at most one code: within 2.5x the row's largest residual, which is
    half a step), in at most 0.1 % of entries; params at atol 1e-4;
  * on each rank's own random gradients: the bucketed sync against the
    per-leaf all-reduce (``naive_psum_sync``) at 1e-6; the int8 mean's
    codes equal to every rank's codes summed by hand, and the per-leaf
    ``make_compressed_grad_sync`` within one quantization step of the
    fp32 mean; ``dequantize_int8`` equal to the reference's; the ZeRO-1
    AdamW update (slices + all_gather) equal to the replicated one, bits;
  * the plain dp step (``train.step.make_train_step`` under a dp2 plan)
    on a batch whose ranks count unequal loss tokens against one rank's
    step on the whole batch: loss and gradient norm at 1e-5, params at
    rtol 1e-4 (atol 1e-6) (the loss is the global token mean, as
    GSPMD's);
  * a rank that raises or dies fails the spawn within seconds, not at
    the group's timeout; an NCCL world larger than the card count
    raises, naming both counts.
"""
import pickle
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from conftest import run_in_subprocess
from repro.parallel import compress as ref_compress
from repro_torch.launch import mesh as mesh_mod
from repro_torch.parallel import compress

CASES = {"dp2": [("fp32", False, 2), ("fp32", True, 2), ("int8", False, 2)],
         "dp4": [("fp32", False, 1), ("fp32", True, 2)]}

REF = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.bench.spec import Placement
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import mesh_for
from repro.models import lm
from repro.parallel import grad_sync as gs
from repro.parallel import sharding as shd
from repro.train.optimizer import OptConfig, opt_init
from repro.train.step import StepConfig

c = get_config("gpt-117m").reduced(dtype="float32", param_dtype="float32")
oc = OptConfig(warmup=2, total_steps=100)
p0 = lm.init(jax.random.key(0), c)
o0 = opt_init(oc, p0)
rng = np.random.default_rng(7)
batches = [rng.integers(0, c.vocab, (8, 16)).astype(np.int32)
           for _ in range(3)]
out = {"params": jax.tree.map(np.asarray, p0), "batches": batches,
       "runs": {}}
for placement, cases in CASES.items():
    plan = shd.make_plan(c, mesh_for(Placement.of(placement)),
                         ShapeConfig("t", 0, 0, "train"))
    for mode, overlap, k in cases:
        sync = gs.GradSyncConfig(mode=mode, bucket_mb=0.01, overlap=overlap)
        step = jax.jit(gs.make_dp_train_step(
            c, oc, StepConfig(microbatches=k), plan=plan, sync=sync))
        p, o, s = p0, o0, gs.init_sync_state(plan, p0, sync)
        losses = []
        for b in batches:
            toks = jnp.asarray(b)
            batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
            batch = jax.device_put(batch, {
                kk: shd.batch_sharding(plan, v.shape)
                for kk, v in batch.items()})
            p, o, s, m = step(p, o, s, batch)
            losses.append(float(m["loss"]))
        out["runs"][(placement, mode, overlap, k)] = {
            "losses": losses,
            "params": [np.asarray(x) for x in jax.tree.leaves(p)],
            "opt": [np.asarray(x) for x in jax.tree.leaves(
                {kk: o[kk] for kk in ("m", "v", "master")})],
            "sync": np.asarray(s)}
pickle.dump(out, open(PATH, "wb"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref_dp") / "ref.pkl"
    run_in_subprocess(f"CASES = {CASES!r}\nPATH = {str(path)!r}\n"
                      + textwrap.dedent(REF), n_devices=4)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(ref):
    return {pl: mesh_mod.spawn(ranks.dp_lm_cases, int(pl[2:]),
                               args=(pl, ref["params"], ref["batches"],
                                     CASES[pl]), device="cpu")
            for pl in CASES}


def _close(got, want, rtol, atol, what):
    assert len(got) == len(want), what
    worst = 0.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)
        worst = max(worst, float(np.abs(g - w).max()) if g.size else 0.0)
    return worst


@pytest.mark.parametrize("case", [(pl, *c) for pl in CASES
                                  for c in CASES[pl]
                                  if c[0] == "fp32"],
                         ids=lambda c: "-".join(map(str, c)))
def test_fp32_dp_steps_match_reference(ref, port, case):
    placement, mode, overlap, k = case
    want = ref["runs"][case]
    per_rank = [r[(mode, overlap, k)] for r in port[placement]]
    got = per_rank[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    worst = _close(got["params"], want["params"], 1e-4, 1e-6, "params")
    worst = max(worst, _close(got["opt"], want["opt"], 1e-4, 1e-6, "opt"))
    for other in per_rank[1:]:        # every rank holds the same params
        assert other["losses"] == got["losses"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(other["params"], got["params"]))
    print(f"\n{case}: losses {got['losses']}, state max |diff| {worst:.3e}")


def test_int8_dp_step_codes_match_reference(ref, port):
    case = ("dp2", "int8", False, 2)
    want = ref["runs"][case]
    per_rank = [r[case[1:]] for r in port["dp2"]]
    np.testing.assert_allclose(per_rank[0]["losses"], want["losses"],
                               rtol=1e-5)
    _close(per_rank[0]["params"], want["params"], 1e-5, 1e-4, "params")
    ref_sync = want["sync"]                  # (ranks, n_buckets, elems)
    flipped, total = 0, 0
    for r, got in enumerate(per_rank):
        g, w = got["sync"][0], ref_sync[r]
        diff = np.abs(g - w)
        step = 2.5 * np.abs(w).max(axis=-1, keepdims=True) + 1e-7
        assert (diff <= step).all(), "a code moved by more than one"
        flipped += int((diff > 1e-6).sum())
        total += diff.size
    assert flipped <= 1e-3 * total, (flipped, total)
    print(f"\nint8 dp2: error-state codes flipped {flipped} of {total}")


@pytest.fixture(scope="module")
def checks():
    return mesh_mod.spawn(ranks.sync_and_update_checks, 2, args=(3,),
                          device="cpu")


def test_plain_dp_step_loss_is_the_global_token_mean(checks):
    dp, one = checks[0]["masked_dp"], checks[0]["masked_one"]
    np.testing.assert_allclose(dp["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(dp["gnorm"], one["gnorm"], rtol=1e-5)
    for a, b in zip(dp["params"], one["params"], strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_naive_psum_sync_matches_bucketed(checks):
    for c in checks:
        assert c["naive_vs_bucketed"] <= 1e-6, c["naive_vs_bucketed"]


def test_int8_codes_sum_over_ranks(checks):
    for c in checks:
        assert c["int8_codes"]
        assert c["int8_residual"] <= 1e-6
        assert c["per_leaf_steps"] <= 1.0 + 1e-4  # the per-leaf form


def test_dequantize_int8_matches_reference():
    x = np.random.default_rng(0).standard_normal((5, 33)).astype(np.float32)
    q, s = compress.quantize_int8(torch.from_numpy(x))
    rq, rs = ref_compress.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(compress.dequantize_int8(q, s).numpy(),
                               np.asarray(ref_compress.dequantize_int8(
                                   rq, rs)), rtol=1e-7)


def test_zero1_update_equals_replicated_update(checks):
    for c in checks:
        assert c["zero1_params_equal"] and c["zero1_state_equal"]
        # each rank keeps about half of AdamW's state
        assert c["sliced_elems"] < 0.6 * c["whole_elems"]


@pytest.mark.parametrize("how", ["raise", "exit"])
def test_a_failed_rank_fails_the_spawn_promptly(how):
    t0 = time.monotonic()
    match = "failed on purpose" if how == "raise" else "exited with code 3"
    with pytest.raises(RuntimeError, match=match):
        mesh_mod.spawn(ranks.fail_on_rank, 2, args=(1, how), device="cpu")
    assert time.monotonic() - t0 < 45


def test_nccl_world_larger_than_the_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks needs 2 cards, this "
                                           "machine has 1"):
        mesh_mod.check_world("nccl", torch.device("cuda"), 2)
    mesh_mod.check_world("gloo", torch.device("cuda"), 2)
    with pytest.raises(ValueError, match="nccl needs cuda"):
        mesh_mod.backend_for(torch.device("cpu"), "nccl")
    assert mesh_mod.backend_for(torch.device("cpu")) == "gloo"
    assert mesh_mod.backend_for(torch.device("cuda")) == "nccl"
