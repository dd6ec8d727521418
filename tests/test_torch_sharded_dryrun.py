"""The sharded serve path and the dry run on meshes of cards.

  * a decode step and a prefill under a plan's layout (K/V heads, the
    head dim or SSM heads over ``model``, a batch below the data axis
    cutting the caches' sequence) on gloo CPU ranks, from the
    reference's weights (``bridge.py``), against the reference's
    prefill and decode step jitted under its ``cache_sharding`` and
    sharding hints on a mesh of forced host devices (logits at atol
    1e-5, the prefill's caches equal to the reference's own cut of its
    caches at atol 1e-5) and against the port's one-process step (the
    same tolerances);
  * the counting mesh's trace of rank 0's tp2 train step: its FLOPs equal
    ``FlopCounterMode``'s count of the real step on CPU ranks, and its
    wire bytes the Megatron reckoning written out below (the reference's
    parsed HLO bytes of ``lower_cell`` on a (2, 2) mesh are printed beside
    the port's count there, ungated: one partitioner's program against
    another's);
  * the same step under Megatron sequence parallelism: its wire bytes
    the reckoning written out below, the reference's parsed HLO bytes of
    ``lower_cell`` with ``plan_overrides={"seq_parallel": True}`` printed
    beside it, ungated; a MoE step with the dispatch buffer's D over
    ``model``: its all-to-alls and their bytes;
  * the production meshes: cells ``ok`` on ``single`` (granite-8b
    train_4k, llama4-maverick decode_32k with experts over ``model`` and
    FSDP, jamba long_500k with the sequence over ``data``), ``multi``'s
    memory-only pass, the links the axes take, and the hill-climb's
    ``dp_only``;
  * ``cache_spec``, ``attn_hints``, ``logits_spec`` and ``grad_specs``
    equal to the reference's shardings;
  * a layer's recompute on another thread (a CUDA backward's) under its
    forward's layout;
  * the ``llm_train`` workload's mixed branch and ``train.diagnose``'s
    ``gspmd-pinned-zero2`` row on CPU ranks.
"""
import dataclasses
import json
import pickle
import textwrap

import numpy as np
import pytest

import _torch_ranks as ranks
from conftest import run_in_subprocess
from repro_torch.bench.spec import Placement
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import mesh as mesh_mod

SERVE = {
    2: [("kv-heads-tp2", "gpt-117m", {}, "tp2", 2),
        ("head-dim-tp2", "gpt-117m", {"n_kv_heads": 1}, "tp2", 2),
        ("ssm-heads-tp2", "mamba2-1.3b", {}, "tp2", 2),
        ("hybrid-tp2", "jamba-v0.1-52b", {"max_position": 1024}, "tp2", 2),
        ("sequence-dp2", "gpt-117m", {}, "dp2", 1)],
    4: [("sequence-head-dim-dp2tp2", "gpt-117m", {"n_kv_heads": 1},
         "dp2tp2", 1),
        ("hybrid-dp2tp2", "jamba-v0.1-52b", {"max_position": 1024},
         "dp2tp2", 2)],
}


REF_SERVE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import _lower_ctx
from repro.launch.mesh import make_mesh
from repro.models import lm
from repro.parallel import sharding as shd
from repro.serve.cache import slotted_cache


def key_of(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)


def cuts(mesh, caches, c, plan):
    # each rank's block (ranks row-major over the mesh) of every leaf
    # under the reference's cache_sharding
    flat = jax.tree_util.tree_flatten_with_path(caches)[0]
    return [{key_of(pth): np.asarray(leaf)[shd.cache_sharding(
        c, plan, pth, leaf.shape).devices_indices_map(leaf.shape)[d]]
        for pth, leaf in flat} for d in mesh.devices.reshape(-1)]


cases = pickle.load(open(IN, "rb"))
out = {}
for name, arch, kw, (dp, tp), toks, nxt, t in cases:
    c = get_config(arch).reduced(dtype="float32", param_dtype="float32",
                                 **kw)
    mesh = make_mesh((dp, tp), ("data", "model"))
    params = jax.jit(lm.init, static_argnums=1)(jax.random.key(0), c)
    b, n_pre = toks.shape
    pshape = ShapeConfig("p", t, b, "prefill")
    dshape = ShapeConfig("d", t, b, "decode")
    pplan = shd.make_plan(c, mesh, pshape)
    dplan = shd.make_plan(c, mesh, dshape)
    with mesh:
        with _lower_ctx(c, pplan, pshape, b):
            pp = jax.device_put(params, shd.param_shardings(c, pplan, params))
            tk = jax.device_put(jnp.asarray(toks),
                                shd.batch_sharding(pplan, toks.shape))
            _l, pre, _e = jax.jit(lambda p, x: lm.prefill(
                c, p, x, impl=pplan.attn_impl))(pp, tk)
        caches = jax.tree_util.tree_map_with_path(
            lambda pth, big, small: big.at[:, :, :n_pre].set(small)
            if pth[-1].key in ("k", "v") else small,
            slotted_cache(c, b, t, None), pre)
        csh = jax.tree_util.tree_map_with_path(
            lambda pth, leaf: shd.cache_sharding(c, dplan, pth, leaf.shape),
            caches)
        with _lower_ctx(c, dplan, dshape, b):
            pd = jax.device_put(params, shd.param_shardings(c, dplan, params))
            tok = jax.device_put(jnp.asarray(nxt),
                                 shd.batch_sharding(dplan, nxt.shape))
            logits, _ = jax.jit(lambda p, x, cs, pos: lm.decode_step(
                c, p, x, cs, pos, impl="grouped"),
                out_shardings=(None, csh))(
                pd, tok, jax.device_put(caches, csh), jnp.int32(n_pre))
    out[name] = {"params": jax.tree.map(np.asarray, params),
                 "caches": jax.tree.map(np.asarray, caches),
                 "logits": np.asarray(logits),
                 "prefill_cuts": cuts(mesh, pre, c, pplan)}
pickle.dump(out, open(OUT, "wb"))
"""

#: a prompt of N_PRE tokens into a slotted cache of T positions
N_PRE, T = 6, 16


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``(reference, port)`` by case: the reference's prefill and decode
    (one subprocess, 4 forced host devices) and every rank's results."""
    d = tmp_path_factory.mktemp("serve")
    inputs, ref_cases = {}, []
    for n, cases in SERVE.items():
        for name, arch, kw, placement, b in cases:
            c = ranks.sharded_config(arch, kw)
            rng = np.random.default_rng(sum(map(ord, name)))
            toks = rng.integers(0, c.vocab, (b, N_PRE)).astype(np.int32)
            nxt = rng.integers(0, c.vocab, (b, 1)).astype(np.int32)
            dp, tp = Placement.of(placement).mesh_shape
            inputs[name] = (toks, nxt)
            ref_cases.append((name, arch, kw, (dp, tp), toks, nxt, T))
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(ref_cases, f)
    run_in_subprocess(f"IN = {str(d / 'in.pkl')!r}\nOUT = "
                      f"{str(d / 'out.pkl')!r}\n" + textwrap.dedent(REF_SERVE),
                      n_devices=4, timeout=900)
    with open(d / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    got = {}
    for n, cases in SERVE.items():
        args = [(name, arch, kw, placement,
                 {"params": ref[name]["params"], "caches": ref[name]["caches"],
                  "toks": inputs[name][0], "nxt": inputs[name][1], "t": T})
                for name, arch, kw, placement, _b in cases]
        for r in mesh_mod.spawn(ranks.sharded_serve, n, args=(args,),
                                device="cpu"):
            for name, v in r.items():
                got.setdefault(name, []).append(v)
    return ref, got


@pytest.mark.parametrize("name", [c[0] for cs in SERVE.values()
                                  for c in cs])
def test_sharded_decode_and_prefill_match_one_process(name, served):
    """Every rank's decode logits and prefill caches against the
    reference's (its own cut of its caches) and the port's one-process
    step's."""
    ref, got = served
    for r in got[name]:
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["logits"], ref[name]["logits"][lo:hi],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["logits"], r["want"], atol=1e-5,
                                   rtol=0)
        want = ref[name]["prefill_cuts"][r["rank"]]
        assert sorted(r["prefill_caches"]) == sorted(want) == \
            sorted(r["want_caches"])
        for key, a in r["prefill_caches"].items():
            np.testing.assert_allclose(a, want[key], atol=1e-5, rtol=0,
                                       err_msg=key)
            np.testing.assert_allclose(a, r["want_caches"][key], atol=1e-5,
                                       rtol=0, err_msg=key)


#: the counted cell: reduced fp32 granite-8b (no biases, untied, RoPE),
#: tp2, one dp rank, two microbatches of four rows
CELL = ("granite-8b", 8, 32, 2)


def _megatron_wire_bytes(c, gb: int, seq: int, k: int) -> float:
    """The tp2 step's ring wire bytes, reckoned from the layout. A
    microbatch of ``b`` rows: the vocabulary-parallel embedding's
    all-reduce, each layer's attention and MLP output all-reduces in the
    forward and the attention's again in its recompute (the recompute
    stops at the last tensor the backward saved, ``torch.utils.
    checkpoint``'s early stop, before the MLP's), their input
    all-reduces in the backward, the unembedding's input all-reduce in
    the backward, the loss's three (B, S) all-reduces (max, sum of
    exponentials, label logit); each layer gathers ``wq`` / ``wk`` /
    ``wv`` over their head dim twice (forward, recompute) and
    reduce-scatters their gradients once. The optimizer: the norm's
    scalar all-reduce and the all-gather of the ZeRO-1 slices of the
    layers' two norm scales over ``model``, the leaves that leave it free
    (the final norm's one dim goes to ``data``, of one rank, as the
    reference's rule takes the largest dim for ``data`` first). Ring bytes
    over 2 ranks: an all-reduce moves its bytes, an all-gather half its
    result, a reduce-scatter its result."""
    b = gb // k
    f = 4                                       # fp32
    bsd, bs = b * seq * c.d_model * f, b * seq * f
    L = c.n_layers
    qkv = c.d_model * (c.n_heads + 2 * c.n_kv_heads) * c.d_head * f
    per_mb = ((2 + 5 * L) * bsd + 3 * bs       # all-reduces
              + 2 * L * qkv / 2                 # all-gathers
              + L * qkv / 2)                    # reduce-scatters
    norms = 2 * L * c.d_model * f
    return k * per_mb + 4 + norms / 2


def _seq_parallel_wire_bytes(c, gb: int, seq: int, k: int) -> float:
    """The tp2 step's ring wire bytes under sequence parallelism. A
    microbatch: all-reduced, the vocabulary-parallel embedding (before
    the cut of the sequence), the unembedding's input in the backward
    (after the gather), the loss's three, and each layer's two norm
    scales' gradients (they apply to the rank's rows); all-gathered over
    the sequence, the cut's gradient, the gather before the final norm
    and, each layer, the attention's and the MLP's inputs in the forward
    and the recompute and their outputs' gradients in the backward;
    reduce-scattered, each layer's two outputs in the forward, the
    attention's again in the recompute (which stops before the MLP's
    output, as above) and the two inputs' gradients. ``wq`` / ``wk`` /
    ``wv`` and the optimizer as in :func:`_megatron_wire_bytes`. Over 2
    ranks a gather of the sequence moves half its result, a
    reduce-scatter its result (half the rows)."""
    b = gb // k
    f = 4
    bsd, bs = b * seq * c.d_model * f, b * seq * f
    L = c.n_layers
    qkv = c.d_model * (c.n_heads + 2 * c.n_kv_heads) * c.d_head * f
    per_mb = ((2 * bsd + 3 * bs + 2 * L * c.d_model * f)   # all-reduces
              + (2 + 6 * L) * bsd / 2                      # all-gathers
              + 5 * L * bsd / 2                            # reduce-scatters
              + 2 * L * qkv / 2 + L * qkv / 2)
    norms = 2 * L * c.d_model * f
    return k * per_mb + 4 + norms / 2


REF_HLO = """
from repro.launch.dryrun import lower_cell
from repro.launch.mesh import make_mesh
from repro.configs import get_config
from repro.configs.base import ShapeConfig
c = get_config(ARCH).reduced(dtype="float32", param_dtype="float32")
for over in (None, {"seq_parallel": True}):
    rec, _ = lower_cell(c, ShapeConfig("t", SEQ, GB, "train"),
                        make_mesh((2, 2), ("data", "model")), "2x2",
                        plan_overrides=over)
    print("WIRE", rec["collectives"]["total_wire_bytes"])
"""


def test_counting_mesh_equals_the_real_rank_step_and_the_reckoning():
    arch, gb, seq, k = CELL
    c = ranks.sharded_config(arch, {})
    shape = ShapeConfig("t", seq, gb, "train")
    got, kk, stats, plan, oc = dryrun.sharded_counts(
        c, shape, mesh_mod.MeshShape((1, 2), ("data", "model")))
    assert kk == k and oc.name == "adamw" and plan.tp_heads
    real = mesh_mod.spawn(ranks.real_rank_flops, 2,
                          args=(arch, {}, "tp2", gb, seq, k), device="cpu")
    assert {r["flops"] for r in real} == {got.flops}
    assert all(r["reduce_scatter_ok"] and r["backend"] == "gloo"
               for r in real)
    want = _megatron_wire_bytes(c, gb, seq, k)
    assert stats.total_wire_bytes == want, (stats.to_dict(), want)
    assert set(stats.groups) == {"model", "data+model"}
    # beside it, ungated: both packages on a (2, 2) mesh
    ours = dryrun.sharded_counts(
        c, dataclasses.replace(shape, global_batch=2 * gb),
        mesh_mod.MeshShape((2, 2), ("data", "model")))[2]
    sp = dryrun.sharded_counts(
        c, shape, mesh_mod.MeshShape((1, 2), ("data", "model")),
        plan_overrides={"seq_parallel": True})[2]
    want_sp = _seq_parallel_wire_bytes(c, gb, seq, k)
    assert sp.total_wire_bytes == want_sp, (sp.to_dict(), want_sp)
    ours_sp = dryrun.sharded_counts(
        c, dataclasses.replace(shape, global_batch=2 * gb),
        mesh_mod.MeshShape((2, 2), ("data", "model")),
        plan_overrides={"seq_parallel": True})[2]
    out = run_in_subprocess(f"ARCH, SEQ, GB = {arch!r}, {seq}, {2 * gb}\n"
                            + textwrap.dedent(REF_HLO), n_devices=4)
    ref, ref_sp = (float(line.split()[1]) for line in out.splitlines()
                   if line.startswith("WIRE"))
    print(f"\n{arch} reduced tp2: meta FLOPs {got.flops:.6e} == the "
          f"CPU ranks' {real[0]['flops']:.6e}; wire bytes {want:.0f} "
          f"(reckoned and counted), with seq_parallel {want_sp:.0f}; "
          f"(2, 2) mesh: port {ours.total_wire_bytes:.0f}, reference's "
          f"parsed HLO {ref:.0f}; with seq_parallel port "
          f"{ours_sp.total_wire_bytes:.0f}, reference {ref_sp:.0f}")


def test_moe_dshard_counts_two_all_to_alls_a_moe_layer_pass():
    """Reduced fp32 granite-moe, tp2 (experts over ``model``), two
    microbatches of four rows: each MoE layer's dispatch buffer goes to
    its experts' ranks and back, two all-to-alls in the forward, two in
    the recompute and two in the backward, each of ``E * cap * D / 2``
    fp32 elements (one ``(E / 2, cap, D)`` or ``(E, cap, D / 2)`` block),
    over ``model``; the combine's all-reduce becomes an all-gather of
    ``D``, and the FLOPs do not change."""
    from repro_torch.models import moe as moe_mod
    c = ranks.sharded_config("granite-moe-3b-a800m", {})
    gb, seq = 8, 32
    shape = ShapeConfig("t", seq, gb, "train")
    mesh = mesh_mod.MeshShape((1, 2), ("data", "model"))
    base, k, plain, _p, _o = dryrun.sharded_counts(c, shape, mesh)
    got, _k, st, plan, _o = dryrun.sharded_counts(
        c, shape, mesh, plan_overrides={"moe_dshard": True})
    assert plan.ep and plan.moe_dshard and k == 2
    cap = moe_mod.expert_capacity(c, gb // k * seq)
    block = c.n_experts * cap * c.d_model // 2 * 4
    n = 6 * c.n_layers * k
    assert st.counts["all-to-all"] == n
    assert st.result_bytes["all-to-all"] == n * block
    assert st.wire_bytes["all-to-all"] == n * block / 2
    assert set(st.groups["model"]["counts"]) >= {"all-to-all"}
    assert got.flops == base.flops
    assert st.counts["all-reduce"] < plain.counts["all-reduce"]


@pytest.mark.parametrize("arch,sname", [
    ("granite-8b", "train_4k"),
    ("llama4-maverick-400b-a17b", "decode_32k"),
    ("jamba-v0.1-52b", "long_500k")])
def test_production_cells_are_ok_on_single(arch, sname, tmp_path):
    assert dryrun.main(["--mesh", "single", "--arch", arch, "--shape",
                        sname, "--out", str(tmp_path)]) == 0
    r = json.loads((tmp_path / f"single__{arch}__{sname}.json").read_text())
    assert r["n_devices"] == 256 and r["fits_hbm_80g"]
    assert r["cost_analysis"]["flops"] > 0
    assert r["collectives"]["total_wire_bytes"] > 0
    assert r["roofline"]["collective_s"] > 0
    # the 16-wide model axis spans two 8-card nodes, as do data's ranks
    assert r["links"]["model"] == "network"
    if sname == "long_500k":
        assert r["plan"]["seq_axis"] == "data"
    if sname == "train_4k":
        assert r["microbatches"] == 8 and r["optimizer"] == "adamw"


def test_multi_is_a_memory_pass_and_links_follow_the_nodes(tmp_path):
    rec = dryrun.lower_cell(get_config("qwen2-0.5b"), SHAPES["train_4k"],
                            "multi")
    assert rec["n_devices"] == 512 and not rec["metrics_pass"]
    assert rec["fits_hbm_80g"] and rec["links"]["pod"] == "network"
    small = dryrun.CountingMesh((2, 4), ("data", "model"))
    assert small.link("model") == "nvlink" and small.link("data") == "nvlink"
    wide = dryrun.CountingMesh((4, 4), ("data", "model"))
    assert wide.link("model") == "nvlink" and wide.link("data") == "network"


def test_hillclimb_dp_only_repurposes_the_model_axis(tmp_path):
    base = hillclimb.run_variant("qwen2-0.5b", "train_4k", "baseline",
                                 tmp_path)
    dp = hillclimb.run_variant("qwen2-0.5b", "train_4k", "dp_only", tmp_path)
    # one mesh for every variant of an invocation: the reference's single
    assert base["mesh"] == dp["mesh"] == "single"
    assert dp["plan"]["use_tp"] is False
    assert base["plan"]["use_tp"] is True
    # no tensor parallelism: the batch over all 256 cards (one row a
    # card, one microbatch), and the all-reduces are the gradients' (at
    # most one a leaf besides the two scalars: CE, norm),
    # not the thousands of activation all-reduces of the baseline's
    from repro_torch.core import tree
    from repro_torch.models import lm
    n_leaves = len(tree.leaves(lm.init_abstract(get_config("qwen2-0.5b"))))
    assert dp["microbatches"] == 1
    assert dp["collectives"]["counts"]["all-reduce"] <= n_leaves + 2 < \
        base["collectives"]["counts"]["all-reduce"]
    assert dp["roofline"]["collective_s"] < base["roofline"][
        "collective_s"]


def test_a_recomputed_layer_keeps_its_forward_layout_on_another_thread():
    """A CUDA backward runs on the autograd engine's device thread, which
    does not inherit the forward's context variables: the layer's
    recompute must still see the layout (and the MoE dispatch). Here the
    backward runs on a fresh thread, on rank 0's shards of a tp2 layout
    over a counting mesh (collectives of the right shapes, no peers)."""
    import threading
    import torch
    from repro_torch.core import tree
    from repro_torch.models import lm
    from repro_torch.parallel import layout as layout_mod
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import StepConfig, make_loss_fn
    c = ranks.sharded_config("granite-moe-3b-a800m", {})
    cm = dryrun.CountingMesh((1, 2), ("data", "model"))
    plan = shd.make_plan(c, cm, ShapeConfig("t", 16, 2, "train"))
    whole = lm.init(c, torch.Generator().manual_seed(0), "cpu")
    zero = shd.Zero1(plan, whole, c)
    p = zero.shard(whole)
    leaves = [x.detach().requires_grad_(True) for x in tree.leaves(p)]
    toks = torch.randint(0, c.vocab, (2, 16))
    with layout_mod.use(zero.layout(())):
        loss, _aux = make_loss_fn(c, StepConfig())(
            tree.unflatten(p, leaves), {"tokens": toks,
                                        "labels": toks.roll(-1, 1)})
    out = {}

    def backward():
        try:
            out["grads"] = torch.autograd.grad(loss, leaves,
                                               allow_unused=True)
        except Exception as e:  # noqa: BLE001 - reported below
            out["error"] = e

    th = threading.Thread(target=backward)
    th.start()
    th.join()
    assert "error" not in out, out.get("error")
    assert all(g is None or g.shape == x.shape
               for g, x in zip(out["grads"], leaves))


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-0.5b",
                                  "jamba-v0.1-52b", "whisper-small"])
def test_cache_attn_logits_and_grad_specs_match_the_reference(arch,
                                                              monkeypatch):
    """The data the dry run and the loss read: ``cache_spec`` of every
    slotted-cache leaf, ``attn_hints``, ``logits_spec`` and the ZeRO-2
    ``grad_specs`` equal to the reference's ``cache_sharding``,
    ``make_attn_hints``, ``logits_sharding`` and ``grad_shardings`` on the
    production meshes and a 2x2 one, for a decode, a long-context decode
    and a train shape."""
    from types import SimpleNamespace
    import jax
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_get_config
    from repro.models import lm as ref_lm
    from repro.parallel import sharding as ref_sh
    from repro_torch.core import tree
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.cache import slotted_cache
    monkeypatch.setattr(ref_sh, "NamedSharding",
                        lambda mesh, spec: SimpleNamespace(mesh=mesh,
                                                           spec=spec))
    c, rc = get_config(arch), ref_get_config(arch)
    whole = lm.init_abstract(c)
    for mshape in ((16, 16), (2, 16, 16), (2, 2)):
        axes = ("pod", "data", "model")[-len(mshape):]
        mesh = mesh_mod.MeshShape(mshape, axes)
        for sname in ("decode_32k", "long_500k", "train_4k"):
            plan = shd.make_plan(c, mesh, SHAPES[sname])
            rplan = ref_sh.make_plan(rc, mesh, REF_SHAPES[sname])
            shape = SHAPES[sname]
            b = shape.global_batch
            caches = slotted_cache(c, b, 64, device="meta")
            for slot, leaves in caches.items():
                for name, t in leaves.items():
                    path = (slot, name)
                    want = ref_sh.cache_sharding(rc, rplan, path,
                                                 tuple(t.shape)).spec
                    assert shd.cache_spec(c, plan, path, tuple(t.shape)) \
                        == tuple(want), (mshape, sname, path)
            got = shd.attn_hints(c, plan, b, cache_seq=shape.seq_len,
                                 decode=shape.kind == "decode",
                                 seq_len=shape.seq_len)
            ref = ref_sh.make_attn_hints(rc, rplan, b,
                                         cache_seq=shape.seq_len,
                                         decode=shape.kind == "decode",
                                         seq_len=shape.seq_len)
            for field in ("q_spec", "kv_spec", "out_spec", "cache_spec",
                          "resid_spec"):
                assert getattr(got, field) == tuple(getattr(ref, field)), \
                    (mshape, sname, field)
            lshape = (b, 8, c.padded_vocab)
            assert shd.logits_spec(plan, lshape) == tuple(
                ref_sh.logits_sharding(rplan, lshape).spec)
        if mshape == (2, 2):         # the ZeRO-2 accumulator's specs
            psp = shd.param_specs(c, plan, whole)
            rp = ref_lm.init_abstract(rc)
            rpsh = ref_sh.param_shardings(rc, rplan, rp)
            want = [tuple(s.spec) for s in jax.tree.leaves(
                ref_sh.grad_shardings(rplan, rpsh, rp),
                is_leaf=lambda x: isinstance(x, SimpleNamespace))]
            assert shd._spec_leaves(shd.grad_specs(plan, psp, whole),
                                    whole) == want
            assert len(tree.leaves(whole)) == len(want)


def test_llm_train_mixed_branch_and_the_diagnose_row(tmp_path, capfd):
    """``llm_train`` at ``placement=dp2tp2`` (a point override; the Space
    keeps the reference's dp placements) takes the reference's mixed
    branch, the plan step on four CPU ranks; ``train.diagnose`` reports
    the ``gspmd-pinned-zero2`` row for it."""
    from repro_torch.bench import cli
    from repro_torch.train import diagnose
    assert cli.main(["run", "--suite", "llm_train", "--smoke", "--device",
                     "cpu", "--power", "none", "--points",
                     "placement=dp2tp2", "--out", str(tmp_path)]) == 0
    recs = json.loads((tmp_path / "llm_train" / "results.json")
                      .read_text())["records"]
    assert [r["point"]["placement"] for r in recs] == ["dp2tp2"]
    m = recs[0]["metrics"]
    assert recs[0]["status"] == "ok" and m["loss_last"] < m["loss_first"]
    rows = diagnose.main(["--placement", "dp2tp2", "--device", "cpu",
                          "--calls", "3"])
    assert [r[0] for r in rows] == ["gspmd-pinned-zero2"]
    assert "gspmd-pinned-zero2" in capfd.readouterr().out
