"""The dry run on ``meta`` tensors against the reference's abstract
shapes and its programs' matmul FLOPs, on the CPU.

  * ``lm.init_abstract`` equals the reference's ``jax.eval_shape`` tree,
    path for path, shape and dtype, for the ten assigned configs at full
    size (both sides are shapes only);
  * ``serve.cache.abstract_caches`` and ``launch.specs``' four functions
    equal the reference's at reduced size; the decode specs' caches,
    built without a prefill, equal ``abstract_caches``'s;
  * ``SHAPES``, ``cells()`` and ``skipped_cells()`` equal the reference's;
  * the meta FLOP count of a prefill, a grouped decode step and one
    microbatch's ``value_and_grad`` under ``remat="full"`` equals the
    ``dot_general`` FLOPs of the reference's jaxpr of the same program
    (a walk into its sub-jaxprs, scans times their length), exactly,
    for a reduced config of each family;
  * the count of a full-depth program equals the 1-vs-2-period
    extrapolation (FLOPs and bytes), and a real step on the CPU counts
    the meta FLOPs under ``FlopCounterMode``;
  * the dry run's records have the reference's schema minus the XLA
    keys, the port's ``roofline`` workload renders them, and both
    packages' ``load_rows`` read the same rows;
  * the hill-climb's plan variants count the step the ranks execute on
    the reference's ``single`` mesh: ``moe_dshard`` of a dense arch
    counts what ``baseline`` counts, ``seq_parallel`` reduce-scatters
    and all-gathers over ``model`` where ``baseline`` all-reduces
    activations; ``baseline``, ``mbs2`` and ``flash_attn`` give records.
"""
import contextlib
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as ref_configs
from repro.bench.workloads import roofline as ref_roofline
from repro.launch import specs as ref_specs
from repro.launch.mesh import make_mesh
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.parallel import sharding as ref_sh
from repro.serve import cache as ref_cache
from repro.serve import engine as ref_engine
from repro.train import step as ref_step
from repro_torch import configs
from repro_torch.bench import cli
from repro_torch.bench.workloads import roofline
from repro_torch.launch import dryrun, hillclimb, specs
from repro_torch.models import lm
from repro_torch.serve import cache
from repro_torch.train import step as train_step
from repro_torch.train.optimizer import opt_init

torch.set_num_threads(1)

FAMILIES = ["llama3.2-3b", "qwen2-0.5b", "granite-moe-3b-a800m",
            "mamba2-1.3b", "jamba-v0.1-52b", "whisper-small",
            "llava-next-34b", "llama4-maverick-400b-a17b"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
#: the reference's record keys (``src/repro/launch/dryrun.py:273-292``)
REF_KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "microbatches",
            "optimizer", "plan", "lower_s", "compile_s", "metrics_s",
            "memory_analysis", "bytes_per_device", "cpu_f32_param_dupe_bytes",
            "bytes_per_device_tpu", "fits_hbm_16g", "fits_hbm_16g_raw_cpu",
            "cost_analysis", "collectives", "roofline"}
#: the XLA keys the port has no analog of (``launch/dryrun.py`` docstring)
XLA_KEYS = {"lower_s", "compile_s", "memory_analysis",
            "cpu_f32_param_dupe_bytes", "bytes_per_device_tpu",
            "fits_hbm_16g", "fits_hbm_16g_raw_cpu"}
PORT_KEYS = {"fits_hbm_80g", "bytes_accessed_bound", "metrics_pass"}
#: the train step's FLOP gap to the reference's contracting dots in the
#: families with broadcasting products (see the test below)
TRAIN_FAMILY_GAP = 0.06


def _leaves(t, prefix=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(t, (tuple, list)):
        for i, v in enumerate(t):
            yield from _leaves(v, prefix + (i,))
    elif t is not None:
        yield prefix, t


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, a in want.items():
        assert tuple(got[path].shape) == tuple(a.shape), path
        assert got[path].dtype == DTYPES[np.dtype(a.dtype).name], path
        assert got[path].device.type == "meta", path


def _configs(arch, **over):
    kw = {"dtype": "float32", "param_dtype": "float32", **over}
    if arch.startswith("jamba"):
        kw.setdefault("max_position", 1024)
    return (ref_configs.get_config(arch).reduced(**kw),
            configs.get_config(arch).reduced(**kw))


def _shape(name, s=32, b=2):
    return dataclasses.replace(configs.SHAPES[name], seq_len=s,
                               global_batch=b)


def _ref_shape(name, s=32, b=2):
    return dataclasses.replace(ref_configs.SHAPES[name], seq_len=s,
                               global_batch=b)


# ---------------------------------------------------------------------------
# Abstract shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(configs.ASSIGNED))
def test_init_abstract_is_the_references_tree(arch):
    _assert_same_tree(lm.init_abstract(configs.get_config(arch)),
                      ref_lm.init_abstract(ref_configs.get_config(arch)))


def test_shapes_and_cells_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    for s in configs.SHAPES.values():
        assert s.tokens_per_step == ref_configs.SHAPES[s.name].tokens_per_step
    assert [(c.name, s.name) for c, s in configs.cells()] == \
        [(c.name, s.name) for c, s in ref_configs.cells()]
    assert configs.skipped_cells() == ref_configs.skipped_cells()
    assert len(configs.cells()) == 33 and len(configs.skipped_cells()) == 7


@pytest.mark.parametrize("arch", FAMILIES)
def test_abstract_caches_and_specs_are_the_references(arch):
    rc, c = _configs(arch, dtype="bfloat16", param_dtype="bfloat16")
    mesh = make_mesh((1, 1), ("data", "model"))
    seq = 64 if c.family == "vlm" else 32
    (caches, enc), kw = cache.abstract_caches(c, 2, seq, lm.init_abstract(c))
    with mesh:
        rshape = _ref_shape("decode_32k", seq)
        plan = ref_sh.make_plan(rc, mesh, rshape)
        (rcaches, renc), rkw = ref_cache.abstract_caches(
            rc, 2, seq, ref_lm.init_abstract(rc))
        aps, _ = ref_specs.abstract_params(rc, plan)
        rdec = ref_specs.decode_specs(rc, plan, rshape, aps)
        rtrain = ref_specs.train_batch_specs(rc, plan,
                                             _ref_shape("train_4k", seq))
        rpre = ref_specs.prefill_specs(rc, plan, _ref_shape("prefill_32k",
                                                            seq))
    _assert_same_tree(caches, rcaches)
    _assert_same_tree(enc, renc)
    _assert_same_tree(kw, rkw)
    _assert_same_tree(specs.abstract_params(c), aps)
    dec = specs.decode_specs(c, _shape("decode_32k", seq),
                             specs.abstract_params(c))
    for got, want in zip(dec, rdec, strict=True):
        _assert_same_tree(got, want)
    for (path, a), (path2, b) in zip(_leaves(dec[1]), _leaves(caches),
                                     strict=True):  # without a prefill
        assert (path, a.shape, a.dtype) == (path2, b.shape, b.dtype)
    _assert_same_tree(specs.train_batch_specs(c, _shape("train_4k", seq)),
                      rtrain)
    _assert_same_tree(specs.prefill_specs(c, _shape("prefill_32k", seq)),
                      rpre)


# ---------------------------------------------------------------------------
# FLOPs against the reference's jaxpr
# ---------------------------------------------------------------------------


def _sub_jaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(x, jax.extend.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jax.extend.core.Jaxpr):
                yield x


def dot_flops(jaxpr) -> tuple[int, int]:
    """``dot_general`` FLOPs (2 x output elements x contracted size) of a
    jaxpr and its sub-jaxprs, split in two: dots that contract a
    dimension, and dots that contract none (an elementwise product with
    broadcasting, which ``jnp.einsum`` of three operands emits). A
    scan's body counts ``length`` times, a cond its largest branch."""
    total = [0, 0]
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _rc), _batch = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval
            total[not lc] += 2 * math.prod(eqn.outvars[0].aval.shape) * \
                math.prod(lhs.shape[i] for i in lc)
            continue
        subs = [dot_flops(j) for j in _sub_jaxprs(eqn.params)]
        if not subs:
            continue
        if eqn.primitive.name == "scan":
            n = eqn.params["length"]
            add = [n * sum(x[i] for x in subs) for i in (0, 1)]
        elif eqn.primitive.name == "cond":
            add = list(max(subs))
        else:
            assert eqn.primitive.name != "while", "unknown trip count"
            add = [sum(x[i] for x in subs) for i in (0, 1)]
        total = [total[0] + add[0], total[1] + add[1]]
    return total[0], total[1]


def _ref_program(rc, kind, seq, b=2):
    p = ref_lm.init_abstract(rc)
    shape = _ref_shape({"train": "train_4k", "prefill": "prefill_32k",
                        "decode": "decode_32k"}[kind], seq, b)
    mesh = make_mesh((1, 1), ("data", "model"))
    with mesh:
        plan = ref_sh.make_plan(rc, mesh, shape)
        if kind == "train":
            batch = ref_specs.train_batch_specs(rc, plan, shape)
            fn = jax.value_and_grad(ref_step.make_loss_fn(
                rc, ref_step.StepConfig(remat="full")), has_aux=True)
            return fn, (p, batch)
        if kind == "prefill":
            tokens, extras = ref_specs.prefill_specs(rc, plan, shape)
            return ref_engine.make_prefill_fn(rc), (p, tokens, extras)
        token, caches, pos, enc = ref_specs.decode_specs(rc, plan, shape, p)
        return ref_engine.make_decode_fn(rc), (p, token, caches, pos, enc)


def _port_counts(c, kind, seq, b=2, depth_full=True):
    shape = _shape({"train": "train_4k", "prefill": "prefill_32k",
                    "decode": "decode_32k"}[kind], seq, b)
    got, _k = dryrun.cell_counts(c, shape, full_depth=depth_full)
    return got, shape


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_flops_equal_the_references_dot_flops(arch, kind):
    """Exact. Where a family differs it is by one op: the reference's
    three-operand einsums (the dense MoE's combine ``tef,te,efd->td``,
    the SSD's ``jnp.einsum`` products with the decay and dt factors)
    lower a broadcasting product to a ``dot_general`` that contracts no
    dimension, 2 x its output elements; the port multiplies those
    factors elementwise, which no FLOP counter counts. The count of
    the dots that contract a dimension is equal in every family's
    prefill and decode, and in the dense, encdec and vlm families'
    train step. The train step of a family with those products differs
    in their backward too: JAX transposes a no-contraction dot into a
    dot that contracts the broadcast dimension, torch's backward of a
    multiply is a multiply and a sum; the router's and the gates'
    backward split differently. Measured gap to the contracting dots:
    granite-moe -0.09 %, mamba2 -4.9 %, jamba -5.4 %, llama4 +1.3 %,
    held within ``TRAIN_FAMILY_GAP``."""
    rc, c = _configs(arch, dtype="bfloat16", param_dtype="bfloat16")
    seq = 64 if c.family == "vlm" else 32
    fn, args = _ref_program(rc, kind, seq)
    with ref_moe.moe_impl("dense") if c.n_experts else \
            contextlib.nullcontext():
        want, elementwise = dot_flops(jax.make_jaxpr(fn)(*args).jaxpr)
    got, _ = _port_counts(c, kind, seq)
    if kind == "train":       # k = 1 here; the optimizer has no matmul
        assert dryrun.microbatching(c, _shape("train_4k", seq, 2))[0] == 1
    products = c.n_experts > 0 or c.ssm_state > 0
    assert (elementwise > 0) == products
    if kind == "train" and products:
        assert got.flops == pytest.approx(want, rel=TRAIN_FAMILY_GAP)
    else:
        assert got.flops == want


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-1.3b",
                                  "jamba-v0.1-52b", "whisper-small"])
def test_full_depth_equals_the_extrapolation(arch, kind):
    """Five periods (and five encoder layers) counted whole equal the
    counts extrapolated from two and three: FLOPs and bytes exactly.
    The peak is not affine in the depth, which is why the dry run
    counts full depth: it is held only to lie near."""
    _, c = _configs(arch, dtype="bfloat16", param_dtype="bfloat16")
    c = dryrun._depth(c, 5, 5 if c.n_enc_layers else None)
    full, _ = _port_counts(c, kind, 32, depth_full=True)
    ex, _ = _port_counts(c, kind, 32, depth_full=False)
    assert ex.flops == full.flops
    assert ex.bytes == pytest.approx(full.bytes, rel=1e-12)
    assert ex.peak == pytest.approx(full.peak, rel=0.1)


@pytest.mark.parametrize("mbs", [4, 5, 20])
def test_train_counts_from_two_microbatches_equal_the_whole_step(mbs):
    """A train cell is traced over two microbatches and counted for k:
    FLOPs and the peak equal a trace of the k-microbatch step exactly,
    the bytes within 1e-6 (the loss's scalar sums count per
    microbatch)."""
    _, c = _configs("granite-moe-3b-a800m", dtype="bfloat16",
                    param_dtype="bfloat16")
    shape = _shape("train_4k", 32, 20)
    got, k = dryrun.cell_counts(c, shape, microbatch_size=mbs)
    assert k == 20 // mbs
    oc = dryrun._pick_opt(c)
    p = lm.init_abstract(c)
    st = opt_init(oc, p)
    batch = specs.train_batch_specs(c, shape)
    step = train_step.make_train_step(c, oc, train_step.StepConfig(
        microbatches=k, remat="full"))
    with dryrun._program_ctx(c):
        want = dryrun.count(lambda: step(p, st, batch), (p, st, batch))
    assert (got.flops, got.peak) == (want.flops, want.peak)
    assert got.bytes == pytest.approx(want.bytes, rel=1e-6)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_real_step_counts_the_meta_flops(kind):
    _, c = _configs("llama3.2-3b")
    shape = _shape({"train": "train_4k", "prefill": "prefill_32k",
                    "decode": "decode_32k"}[kind], 32, 4)
    rec = dryrun.real_step(c, shape, "cpu")
    assert rec["flops_device"] == rec["flops_meta"] > 0
    assert rec["peak_bytes_measured"] is None          # no card
    assert rec["step_ms"] > 0 and rec["bound_ms"] > 0


def test_tally_flops_equal_flop_counter_mode():
    _, c = _configs("granite-moe-3b-a800m", dtype="bfloat16",
                    param_dtype="bfloat16")
    p = lm.init_abstract(c)
    batch = specs.train_batch_specs(c, _shape("train_4k", 32))
    vg = train_step.value_and_grad(train_step.make_loss_fn(
        c, train_step.StepConfig()))
    with dryrun._program_ctx(c):
        got = dryrun.count(lambda: vg(p, batch), (p, batch))
        with FlopCounterMode(display=False) as fc:
            vg(p, batch)
    assert got.flops == fc.get_total_flops() > 0


# ---------------------------------------------------------------------------
# Records, the roofline workload, the hill-climb
# ---------------------------------------------------------------------------


@pytest.fixture
def reduced_cells(monkeypatch, tmp_path):
    """The dry run's cells at reduced size: reduced configs, shapes cut
    to 64 positions and batch 2."""
    def get(arch):
        return _configs(arch, dtype="bfloat16", param_dtype="bfloat16")[1]

    small = {n: _shape(n, 64, 2) for n in configs.SHAPES}
    monkeypatch.setattr(dryrun, "get_config", get)
    monkeypatch.setattr(dryrun, "SHAPES", small)
    monkeypatch.setenv("REPRO_DRYRUN_DIR", str(tmp_path / "dry"))
    return tmp_path


def test_dry_run_records_and_the_roofline_workload(reduced_cells, capsys):
    tmp = reduced_cells
    archs = ["qwen2-0.5b", "mamba2-1.3b"]
    assert dryrun.main(["--arch", archs[0], "--arch", archs[1],
                        "--out", str(tmp / "dry")]) == 0
    recs = [json.loads(f.read_text())
            for f in sorted((tmp / "dry").glob("*.json"))]
    assert len(recs) == 7     # the skipped cell is reported, not written
    for r in recs:
        assert set(r) == REF_KEYS - XLA_KEYS | PORT_KEYS, r["shape"]
        assert r["mesh"] == "1xh100" and r["n_devices"] == 1
        assert r["collectives"]["total_wire_bytes"] == 0.0
        assert r["roofline"]["collective_s"] == 0.0
        assert r["fits_hbm_80g"] is True
        assert r["plan"]["attn_impl"] == (
            "grouped" if r["kind"] == "decode" else "repeat")
    out = "[dryrun] done: 7 ok, 1 skipped, 0 FAILED"
    assert out in capsys.readouterr().out
    # the port's rows equal the reference's reader's, but for the fits
    # flag (the reference reads fits_hbm_16g)
    got, want = roofline.load_rows("1xh100"), ref_roofline.load_rows("1xh100")
    assert len(got) == 7      # a skipped cell writes no record, as there
    assert [{k: v for k, v in r.items() if k != "fits"} for r in got] == \
        [{k: v for k, v in r.items() if k != "fits"} for r in want]
    assert all(r.get("fits") is True for r in got if "note" not in r)
    # the workload renders them, and rank 0's records of the 256-card
    # mesh beside them (a mesh without records renders none)
    assert dryrun.main(["--mesh", "single", "--arch", archs[0],
                        "--out", str(tmp / "dry")]) == 0
    rc = cli.main(["run", "--suite", "roofline", "--device", "cpu",
                   "--power", "none", "--out", str(tmp / "bench")])
    assert rc == 0
    res = json.loads((tmp / "bench" / "roofline" / "results.json")
                     .read_text())["records"]
    by = {r["point"]["mesh"]: r for r in res}
    assert {r["status"] for r in res} == {"ok"}
    assert [by[m]["metrics"]["n_rows"] for m in ("1xh100", "single",
                                                 "multi")] == [7, 3, 0]


def test_load_rows_read_reference_records_as_the_reference(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_DIR", str(tmp_path))
    rf = {"compute_s": 1.5, "memory_s": 0.25, "collective_s": 0.125,
          "bottleneck": "compute", "roofline_fraction": 1.0,
          "useful_flops_ratio": 0.75}
    rows = [
        {"arch": "a", "shape": "train_4k", "roofline": rf,
         "bytes_per_device": 3 * 2**30, "bytes_per_device_tpu": 2 * 2**30,
         "fits_hbm_16g": True},
        {"arch": "b", "shape": "long_500k", "skipped": "full quadratic"},
        {"arch": "c", "shape": "decode_32k", "error": "boom"},
    ]
    for i, r in enumerate(rows):
        (tmp_path / f"single__{r['arch']}__{i}.json").write_text(json.dumps(r))
    assert roofline.load_rows("single") == ref_roofline.load_rows("single")
    assert roofline.load_rows("multi") == []


def test_dry_run_counts_the_reference_meshes(tmp_path):
    """``--mesh both`` writes a record for each production mesh: rank 0
    of 256 and 512 cards, with collectives, their links and a non-zero
    collective term."""
    assert dryrun.main(["--mesh", "both", "--arch", "qwen2-0.5b",
                        "--shape", "decode_32k", "--out",
                        str(tmp_path)]) == 0
    for mesh, n in (("single", 256), ("multi", 512)):
        r = json.loads((tmp_path / f"{mesh}__qwen2-0.5b__decode_32k.json")
                       .read_text())
        assert r["n_devices"] == n and r["fits_hbm_80g"]
        assert r["collectives"]["total_wire_bytes"] > 0
        assert r["roofline"]["collective_s"] > 0
        assert set(r["links"].values()) == {"network"}


def test_the_optimizer_follows_the_references_rule_at_80_gb():
    for name, c in configs.ASSIGNED.items():
        want = "adafactor" if c.param_count() * 12 > 40e9 else "adamw"
        assert dryrun._pick_opt(c).name == want, name
    assert dryrun._pick_opt(configs.get_config("llama3.2-3b")).name == "adamw"
    assert dryrun._pick_opt(configs.get_config("granite-8b")).name == \
        "adafactor"


def test_hillclimb_variants(tmp_path):
    recs = {v: hillclimb.run_variant("qwen2-0.5b", "train_4k", v, tmp_path)
            for v in ("baseline", "seq_parallel", "moe_dshard",
                      "mbs2+moe_dshard")}
    model = {v: r["collectives"]["groups"]["model"]
             for v, r in recs.items()}
    # a dense arch: the MoE buffer's cut changes nothing
    assert recs["moe_dshard"]["collectives"] == \
        recs["baseline"]["collectives"]
    assert recs["moe_dshard"]["cost_analysis"] == \
        recs["baseline"]["cost_analysis"]
    assert recs["mbs2+moe_dshard"]["microbatches"] == 8
    # sequence parallelism: the sequence reduce-scattered and gathered
    # over model; what stays all-reduced there is the embedding, the
    # loss, the unembedding's input gradient and the norms' gradients
    assert "reduce-scatter" not in model["baseline"]["counts"]
    assert model["seq_parallel"]["counts"]["reduce-scatter"] > 0
    assert model["seq_parallel"]["counts"]["all-gather"] > \
        model["baseline"]["counts"]["all-gather"]
    ar = {v: recs[v]["collectives"]["result_bytes"]["all-reduce"]
          for v in ("baseline", "seq_parallel")}
    assert ar["seq_parallel"] < ar["baseline"] / 2
    assert recs["seq_parallel"]["cost_analysis"]["flops"] == \
        recs["baseline"]["cost_analysis"]["flops"]
    assert tuple(recs["seq_parallel"]["attn_hints"]["resid_spec"]) == \
        ("data", "model", None)
    for v in recs:
        assert (tmp_path / f"qwen2-0.5b__train_4k__{v}.json").exists()
    with pytest.raises(ValueError, match="unknown variant"):
        hillclimb.run_variant("qwen2-0.5b", "train_4k", "mbs3", tmp_path)
    # one H100 by name: the default is the reference's mesh, single
    base = hillclimb.run_variant("qwen2-0.5b", "train_4k", "baseline",
                                 tmp_path, "1xh100")
    mbs2 = hillclimb.run_variant("qwen2-0.5b", "train_4k", "mbs2", tmp_path,
                                 "1xh100")
    assert (base["microbatches"], mbs2["microbatches"]) == (64, 128)
    assert base["mesh"] == mbs2["mesh"] == "1xh100"
    assert base["variant"] == "baseline" and mbs2["variant"] == "mbs2"
    # same FLOPs, more optimizer-free passes over the weights
    assert mbs2["cost_analysis"]["flops"] == base["cost_analysis"]["flops"]
    assert mbs2["cost_analysis"]["bytes_accessed"] > \
        base["cost_analysis"]["bytes_accessed"]
    assert (tmp_path / "qwen2-0.5b__train_4k__mbs2.json").exists()
    with pytest.raises(ValueError, match="one card's kernel"):
        hillclimb.run_variant("qwen2-0.5b", "prefill_32k", "flash_attn",
                              tmp_path)
    fl = hillclimb.run_variant("qwen2-0.5b", "prefill_32k", "flash_attn",
                               tmp_path, "1xh100")
    fm = fl["flash_model"]
    assert fm["attn_core_flops_measured"] > 0
    assert fm["attn_core_bytes_measured"] > fm["flash_streaming_bytes"] > 0
