"""Tensor-, expert- and fully-sharded layouts executed across ranks,
against the port's one-process step and the reference's GSPMD step.

Each case trains a reduced fp32 config, from the reference's weights
(``bridge.py``), on seeded numpy batches: three AdamW (or Adafactor)
steps of ``make_train_step(plan=...)`` on gloo CPU ranks (one spawn a
placement, every case of it in turn), the same steps on one process,
and the reference's ``make_train_step(grad_shardings=...,
batch_shardings=...)`` under ``jax.jit`` on a ``("data", "model")`` mesh
of forced host devices in one subprocess (``conftest.run_in_subprocess``,
as ``tests/test_parallel.py`` runs it).

  * against the one-process step: losses at rtol 1e-5, params after
    three steps at atol 1e-5;
  * against the reference's GSPMD step: losses at rtol 1e-5 and the
    first step's gradients at atol 1e-4;
  * each rank holds the elements its shards reckon: the reference's
    ``PartitionSpec`` of every leaf, read in the subprocess, cuts the
    whole leaf by the mesh sizes it names.

The AdamW runs use ``eps=1e-6``: AdamW divides each element's first
moment by its own RMS, so an element whose gradient is ~1e-8 (an
embedding row of a token seen once, reached through the residual
stream) takes an update of ~lr whose size at ``eps=1e-8`` depends on the
last bits of its gradient; there a different summation order (the
ranks' partial sums) moved one such element by 3e-5 in three steps while
the gradients agreed to 1e-7. ``eps=1e-6`` keeps those updates
proportional to the gradient. The gradients are compared directly.

The MoE case of the plan step's global semantics (microbatch ``i`` is
global rows ``[i mb, (i+1) mb)``, the capacity and the drops over the
global microbatch, the load-balancing means over every rank's tokens)
runs dp2 with two microbatches and a capacity factor that drops pairs.

The plan variants (the last field of a case: plan fields set on top of
``make_plan``'s): Megatron sequence parallelism (``seq_parallel``; split
attention and MLP, K/V computed whole, the mamba mixer computed whole,
the MoE router) and the MoE dispatch buffer's D over ``model``
(``moe_dshard``, with drops and the global ranking over dp2). The
reference runs them as its dry run lowers them, its step jitted inside
``repro.launch.dryrun._lower_ctx`` with the same plan (the residual's
``resid_spec``, the buffer's ``buf_spec``). Sequence parallelism at a
sequence that tp does not divide (15) is plain tp, as the reference's
``sp_ax`` is None there: its params equal the plain tp2 run's bit for
bit.
"""
import pickle
import textwrap

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from conftest import run_in_subprocess
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import apply_norm, embed_tokens

B, S, STEPS = 4, 16, 3
ADAM = {"eps": 1e-6}
SP, DSHARD = {"seq_parallel": True}, {"moe_dshard": True}

#: name -> (arch, reduced overrides, (dp, tp), microbatches, optimizer,
#: force_fsdp, plan fields)
CASES = {
    "gpt-tp2": ("gpt-117m", {}, (1, 2), 1, ADAM, None, {}),
    "gpt-dp2tp2": ("gpt-117m", {}, (2, 2), 1, ADAM, None, {}),
    "gpt-fsdp-dp2": ("gpt-117m", {}, (2, 1), 1, ADAM, True, {}),
    "gpt-fsdp-dp2tp2": ("gpt-117m", {}, (2, 2), 1, ADAM, True, {}),
    "gpt-adafactor-tp2": ("gpt-117m", {}, (1, 2), 1,
                          {"name": "adafactor"}, None, {}),
    "granite8b-tp4": ("granite-8b", {}, (1, 4), 1, ADAM, None, {}),
    "granite8b-h6-tp4": ("granite-8b", {"n_heads": 6}, (1, 4), 1, ADAM,
                         None, {}),
    "moe-ep-tp2": ("granite-moe-3b-a800m", {}, (1, 2), 1, ADAM, None, {}),
    "moe-e6-tp4": ("granite-moe-3b-a800m", {"n_experts": 6}, (1, 4), 1,
                   ADAM, None, {}),
    "moe-global-dp2": ("granite-moe-3b-a800m", {"capacity_factor": 0.5},
                       (2, 1), 2, ADAM, None, {}),
    "mamba-dp2tp2": ("mamba2-1.3b", {}, (2, 2), 1, ADAM, None, {}),
    "whisper-tp2": ("whisper-small", {}, (1, 2), 1, ADAM, None, {}),
    "llava-tp2": ("llava-next-34b", {}, (1, 2), 1, ADAM, None, {}),
    "gpt-tp2-sp": ("gpt-117m", {}, (1, 2), 1, ADAM, None, SP),
    "gpt-dp2tp2-sp": ("gpt-117m", {}, (2, 2), 1, ADAM, None, SP),
    "gpt-tp2-s15": ("gpt-117m", {}, (1, 2), 1, ADAM, None, {}),
    "gpt-tp2-sp-s15": ("gpt-117m", {}, (1, 2), 1, ADAM, None, SP),
    "granite8b-tp4-sp": ("granite-8b", {}, (1, 4), 1, ADAM, None, SP),
    "moe-ep-tp2-sp": ("granite-moe-3b-a800m", {}, (1, 2), 1, ADAM, None,
                      SP),
    "mamba-tp2-sp": ("mamba2-1.3b", {}, (1, 2), 1, ADAM, None, SP),
    "moe-ep2-dshard": ("granite-moe-3b-a800m", {}, (1, 2), 1, ADAM, None,
                       DSHARD),
    "moe-dp2ep2-dshard-drops": ("granite-moe-3b-a800m",
                                {"capacity_factor": 0.5}, (2, 2), 2, ADAM,
                                None, DSHARD),
}
#: cases at another sequence length than ``S``
SEQ = {"gpt-tp2-s15": 15, "gpt-tp2-sp-s15": 15}

REF = """
import contextlib, dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import _lower_ctx
from repro.launch.mesh import make_mesh
from repro.models import lm
from repro.parallel import sharding as shd
from repro.train.optimizer import OptConfig, opt_init
from repro.train.step import StepConfig, make_loss_fn, make_train_step

cases, batches = pickle.load(open(IN, "rb"))
out = {}
for name, (arch, kw, (dp, tp), k, opt, fsdp, flags) in cases.items():
    c = get_config(arch).reduced(dtype="float32", param_dtype="float32",
                                 **kw)
    oc = OptConfig(warmup=2, total_steps=100, **opt)
    mesh = make_mesh((dp, tp), ("data", "model"))
    params = jax.jit(lm.init, static_argnums=1)(jax.random.key(0), c)
    bts = batches[name]
    shape = ShapeConfig("t", bts[0]["tokens"].shape[1],
                        bts[0]["tokens"].shape[0], "train")
    plan = dataclasses.replace(shd.make_plan(c, mesh, shape,
                                             force_fsdp=fsdp), **flags)
    rec = {"params": jax.tree.map(np.asarray, params)}
    p, o, psh, osh, gsh = shd.shard_train_state(plan, params,
                                                opt_init(oc, params), c)
    rec["elems"] = sum(
        int(np.prod(l.shape)) // int(np.prod(
            [mesh.shape[a] for part in s.spec if part is not None
             for a in ((part,) if isinstance(part, str) else part)]))
        for l, s in zip(jax.tree.leaves(params), jax.tree.leaves(psh)))
    mb = bts[0]["tokens"].shape[0] // k
    bsh = {key: shd.batch_sharding(plan, (mb,) + v.shape[1:])
           for key, v in bts[0].items()}
    put = lambda bt: jax.device_put(
        {key: jnp.asarray(v) for key, v in bt.items()},
        {key: shd.batch_sharding(plan, v.shape) for key, v in bt.items()})
    # the plan variants as the dry run lowers them (resid_spec, buf_spec)
    lower = (_lower_ctx(c, plan, shape, shape.global_batch // k) if flags
             else contextlib.nullcontext())
    with mesh, lower:
        if k == 1:
            vg = jax.jit(jax.value_and_grad(make_loss_fn(c, StepConfig()),
                                            has_aux=True))
            rec["grads"] = [np.asarray(g) for g in
                            jax.tree.leaves(vg(p, put(bts[0]))[1])]
        step = jax.jit(make_train_step(c, oc, StepConfig(microbatches=k),
                                       grad_shardings=gsh,
                                       batch_shardings=bsh),
                       out_shardings=(psh, osh, None))
        rec["metrics"] = []
        for bt in bts:
            p, o, m = step(p, o, put(bt))
            rec["metrics"].append({key: float(v) for key, v in m.items()})
    out[name] = rec
pickle.dump(out, open(OUT, "wb"))
"""


def _batches(name: str) -> list:
    arch, kw, *_ = CASES[name]
    c = ranks.sharded_config(arch, kw)
    # the s15 pair shares its batches (the plain run is the SP run's twin)
    rng = np.random.default_rng(sum(map(ord, name.replace("-sp", ""))))
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, c.vocab, (B, SEQ.get(name, S))).astype(np.int32)
        bt = {"tokens": t, "labels": np.roll(t, -1, 1)}
        if c.family == "encdec":
            bt["enc_frames"] = rng.standard_normal(
                (B, c.enc_seq, c.d_model)).astype(np.float32)
        if c.family == "vlm":
            bt["patch_embeds"] = rng.standard_normal(
                (B, c.n_patches, c.d_model)).astype(np.float32)
        out.append(bt)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's GSPMD runs (one subprocess), the port's rank runs
    (one spawn a placement) and its one-process runs, by case."""
    d = tmp_path_factory.mktemp("tp")
    batches = {name: _batches(name) for name in CASES}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((CASES, batches), f)
    run_in_subprocess(f"IN = {str(d / 'in.pkl')!r}\nOUT = "
                      f"{str(d / 'out.pkl')!r}\n" + textwrap.dedent(REF),
                      n_devices=4, timeout=900)
    with open(d / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    by_mesh: dict = {}
    for name, (arch, kw, mesh, k, opt, fsdp, flags) in CASES.items():
        by_mesh.setdefault(mesh, []).append(
            (name, arch, kw, f"dp{mesh[0]}tp{mesh[1]}", ref[name]["params"],
             batches[name], opt, k, fsdp, flags))
    got = {}
    for (dp, tp), cases in by_mesh.items():
        per_rank = mesh_mod.spawn(ranks.sharded_cases, dp * tp,
                                  args=(cases,), device="cpu")
        for name in per_rank[0]:
            got[name] = [r[name] for r in per_rank]
    one = {name: ranks.one_process_steps(arch, kw, ref[name]["params"],
                                         batches[name], opt, k)
           for name, (arch, kw, _m, k, opt, _f, _p) in CASES.items()}
    return ref, got, one, batches


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_one_process_and_the_reference(name, runs):
    ref, got, one, _ = runs
    r0 = got[name][0]
    losses = [m["loss"] for m in r0["metrics"]]
    np.testing.assert_allclose(losses, [m["loss"] for m in one[name][
        "metrics"]], rtol=1e-5)
    np.testing.assert_allclose(losses, [m["loss"] for m in ref[name][
        "metrics"]], rtol=1e-5)
    np.testing.assert_allclose([m["aux"] for m in r0["metrics"]],
                               [m["aux"] for m in ref[name]["metrics"]],
                               rtol=1e-5, atol=1e-7)
    worst = 0.0
    for a, b in zip(r0["params"], one[name]["params"], strict=True):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        worst = max(worst, float(np.abs(a - b).max()))
    if "grads" in ref[name]:
        for a, b in zip(r0["grads"], ref[name]["grads"], strict=True):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    for r in got[name][1:]:      # every rank holds the same whole params
        assert all(np.array_equal(a, b) for a, b in
                   zip(r["params"], r0["params"]))
    # each rank stores what its shards reckon, the reference's specs' cut
    assert {r["elems"] for r in got[name]} == {ref[name]["elems"]}
    print(f"\n{name}: losses {losses}, params max |diff| vs one process "
          f"{worst:.3e}, elements a rank {r0['elems']} of "
          f"{one[name]['elems']}, optimizer state {r0['opt_elems']} of "
          f"{one[name]['opt_elems']}")


def test_moe_case_drops_pairs_over_the_global_microbatch(runs):
    """The global-semantics MoE cases (dp2, and dp2 with the buffer's D
    over ``model``) route more pairs to some expert than the capacity of
    the global microbatch holds (layer 0, microbatch 0), so drops are in
    play, and their losses and aux are the reference's (above)."""
    ref, _got, _one, batches = runs
    from repro_torch import bridge
    for name in ("moe-global-dp2", "moe-dp2ep2-dshard-drops"):
        arch, kw, _m, k, _o, _f, _p = CASES[name]
        c = ranks.sharded_config(arch, kw)
        p = bridge.params_from_numpy(ref[name]["params"], "cpu")
        toks = torch.from_numpy(batches[name][0]["tokens"][:B // k])
        x = embed_tokens(c, p["embed"], toks)
        lp = {n: t[0] for n, t in p["layers"]["slot0"]["norm2"].items()}
        x2d = apply_norm(c, lp, x).reshape(-1, c.d_model)
        _w, idx, _aux = moe_mod.router_topk(
            c, {"router": p["layers"]["slot0"]["moe"]["router"][0]}, x2d)
        counts = np.bincount(idx.reshape(-1).numpy(),
                             minlength=c.n_experts)
        assert counts.max() > moe_mod.expert_capacity(c, x2d.shape[0]), \
            name


def test_vocab_parallel_loss_equals_the_whole_vocabulary_loss():
    got = mesh_mod.spawn(ranks.vocab_parallel_loss, 2, device="cpu")
    for r in got:
        for key in ("ce", "ce_z"):
            np.testing.assert_allclose(r[key], r[key + "_whole"], rtol=1e-6)
        np.testing.assert_allclose(r["grad"], r["grad_whole"], atol=1e-7)


def test_checkpoint_of_dp2tp2_restores_into_tp2_and_dp1(tmp_path):
    got = mesh_mod.spawn(ranks.sharded_checkpoint, 4,
                         args=(str(tmp_path), "dp2tp2", True),
                         device="cpu")
    tp2 = mesh_mod.spawn(ranks.sharded_checkpoint, 2,
                         args=(str(tmp_path), "tp2", False), device="cpu")
    dp1 = ranks.sharded_checkpoint(None, str(tmp_path), "dp1", False)
    want = got[0]["whole"]
    for r in [*got, *tp2, dp1]:
        assert r["step"] == 2
        for a, b in zip(r["whole"], want, strict=True):
            assert np.array_equal(a, b)
    # the restored runs take the same next step
    np.testing.assert_allclose(tp2[0]["next_loss"], dp1["next_loss"],
                               rtol=1e-5)


def test_train_cli_trains_dp2tp2_on_cpu_ranks(capfd):
    from repro_torch.launch import train as train_cli
    res = train_cli.main(["--device", "cpu", "--placement", "dp2tp2",
                          "--steps", "3", "--seq-len", "32",
                          "--global-batch", "4"])
    assert res.steps_run == 3 and np.isfinite(res.losses).all()
    out = capfd.readouterr().out
    assert "placement=dp2tp2" in out and "[train] done" in out


def test_seq_parallel_at_an_undivided_sequence_is_plain_tp(runs):
    """SP asked for at S = 15 on tp2 runs plain tp (the reference's
    ``sp_ax`` is None): its steps equal the plain tp2 run's bit for bit."""
    _ref, got, _one, _b = runs
    for a, b in zip(got["gpt-tp2-sp-s15"], got["gpt-tp2-s15"], strict=True):
        assert a["metrics"] == b["metrics"]
        assert all(np.array_equal(x, y) for x, y in
                   zip(a["params"], b["params"], strict=True))


def test_seq_parallel_and_moe_dshard_execute():
    """Both plan variants build a rank's layout (no flag raises) and
    change what the counting mesh counts of the tp2 step: sequence
    parallelism reduce-scatters and all-gathers the sequence where plain
    tp all-reduces activations, and counts what plain tp counts at a
    sequence that tp does not divide; ``moe_dshard`` all-to-alls an
    expert-parallel MoE's dispatch buffer and changes nothing of a dense
    arch."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    import dataclasses
    mesh = mesh_mod.MeshShape((1, 2), ("data", "model"))

    def counted(arch, seq, **flags):
        c = ranks.sharded_config(arch, {})
        got = dryrun.sharded_counts(c, ShapeConfig("t", seq, B, "train"),
                                    mesh, plan_overrides=flags or None)
        return got[2].to_dict(), got[3]

    for arch, flags in (("gpt-117m", SP), ("granite-moe-3b-a800m", DSHARD)):
        c = ranks.sharded_config(arch, {})
        plan = dataclasses.replace(shd.make_plan(
            c, mesh, ShapeConfig("t", S, B, "train")), **flags)
        lay = shd.Zero1(plan, lm.init_abstract(c), c).layout()
        assert (lay.seq_parallel, lay.moe_dshard) == (
            "seq_parallel" in flags, "moe_dshard" in flags)
    plain, _ = counted("gpt-117m", S)
    sp, plan = counted("gpt-117m", S, **SP)
    assert plan.seq_parallel
    assert sp["counts"]["reduce-scatter"] > plain["counts"]["reduce-scatter"]
    assert sp["counts"]["all-gather"] > plain["counts"]["all-gather"]
    # what stays all-reduced over model under SP: the embedding, the loss,
    # the unembedding's input gradient and the norms' gradients
    assert sp["result_bytes"]["all-reduce"] < \
        plain["result_bytes"]["all-reduce"] / 2
    assert counted("gpt-117m", 15, **SP)[0] == counted("gpt-117m", 15)[0]
    moe, _ = counted("granite-moe-3b-a800m", S)
    dsh, _ = counted("granite-moe-3b-a800m", S, **DSHARD)
    assert "all-to-all" not in moe["counts"] and dsh["counts"]["all-to-all"]
    assert counted("gpt-117m", S, **DSHARD)[0] == plain
