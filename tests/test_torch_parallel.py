"""The port's sharding rules, meshes and data-parallel ResNet against
``repro``'s, on the CPU.

  * ``make_plan``'s flags and every parameter leaf's ``_param_rule`` spec
    equal to the reference's (its ``PartitionSpec`` as a tuple), for every
    ``ASSIGNED`` arch on the reference's shape-only 16x16 and 2x16x16
    meshes (``tests/test_parallel.py``), one case per (arch, mesh);
  * ``zero1_spec`` equal to the reference's ``zero1_sharding``
    (``test_parallel.py:69``'s three cases, and every leaf of two archs
    on 2x2, 16x16 and 2x16x16), ``batch_spec`` to ``batch_sharding``,
    ``make_dp_plan`` and ``Placement``'s mesh axes to the reference's;
  * a mesh of ranks: coordinates, groups and batch rows, and a one-rank
    mesh without a process group;
  * the dp2 ResNet step, BatchNorm's statistics synced over the ranks,
    against the reference's dp2 GSPMD step (forced host devices in a
    subprocess) on the same weights and global batch: losses and params
    after three AdamW steps at rtol 1e-4 (atol 1e-5).
"""
import functools
import pickle
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import _torch_ranks as ranks
from conftest import run_in_subprocess
from repro.bench.spec import Placement as RefPlacement
from repro.configs import ASSIGNED as REF_ASSIGNED
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.parallel import sharding as ref_sh
from repro_torch.bench.spec import Placement
from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.core import tree
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.parallel import sharding as sh


class _FakeMesh:
    """Shape-only mesh stand-in (the reference test's)."""

    def __init__(self, shape_map):
        self.shape = dict(shape_map)
        self.axis_names = tuple(shape_map)
        self.size = int(np.prod(list(shape_map.values())))


MESHES = {"pod1": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}


@functools.cache
def _abstract(arch: str):
    """Both packages' shape-only params of ``arch`` (the reference's
    ``eval_shape`` takes ~20 s for llama4-maverick), once per process."""
    return (ref_lm.init_abstract(ref_get_config(arch)),
            lm.init_abstract(get_config(arch)))


def _names(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "name", str(k))) for k in path)


@pytest.fixture
def fake_named_sharding(monkeypatch):
    """The reference's spec functions build ``NamedSharding``s, which need
    a real mesh; a stand-in keeps their spec."""
    monkeypatch.setattr(ref_sh, "NamedSharding",
                        lambda mesh, spec: SimpleNamespace(mesh=mesh,
                                                           spec=spec))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_plan_and_param_rules_match_reference(arch, mesh):
    assert sorted(ASSIGNED) == sorted(REF_ASSIGNED)
    rc, c = ref_get_config(arch), get_config(arch)
    fm = _FakeMesh(MESHES[mesh])
    for shape in ("train_4k", "decode_32k", "long_500k"):
        rplan = ref_sh.make_plan(rc, fm, REF_SHAPES[shape])
        plan = sh.make_plan(c, fm, SHAPES[shape])
        for f in ("dp", "tp", "tp_size", "fsdp", "tp_heads", "ep",
                  "seq_axis", "attn_impl", "use_tp"):
            assert getattr(plan, f) == getattr(rplan, f), (shape, f)
    rplan = ref_sh.make_plan(rc, fm, REF_SHAPES["train_4k"])
    plan = sh.make_plan(c, fm, SHAPES["train_4k"])
    rp, ap = _abstract(arch)
    want = [(_names(p), tuple(ref_sh._param_rule(rc, rplan, p,
                                                 tuple(x.shape))))
            for p, x in jax.tree_util.tree_flatten_with_path(rp)[0]]
    got = [(tuple(p), sh._param_rule(c, plan, p, tuple(x.shape)))
           for p, x in tree.paths(ap)]
    assert got == want
    specs = sh.param_specs(c, plan, ap)
    assert sh._spec_leaves(specs, ap) == [s for _, s in got]


def test_zero1_specs_match_reference(fake_named_sharding):
    c, rc = get_config("granite-8b"), ref_get_config("granite-8b")
    # the reference test's three cases on a 2x2 mesh
    fm = _FakeMesh({"data": 2, "model": 2})
    rplan = ref_sh.make_plan(rc, fm, REF_SHAPES["train_4k"])
    plan = sh.make_plan(c, fm, SHAPES["train_4k"])
    cases = [((None, "model"), (8, 4)), (("data", None), (8, 4)),
             ((), (7,))]
    for spec, shape in cases:
        want = ref_sh.zero1_sharding(
            rplan, SimpleNamespace(spec=jax.sharding.PartitionSpec(*spec)),
            shape).spec
        assert sh.zero1_spec(plan, spec, shape) == tuple(want)
    assert sh.zero1_spec(plan, (None, "model"), (8, 4)) == ("data", "model")
    assert sh.zero1_spec(plan, (), (7,)) == (None,)
    # every leaf of two archs on three meshes, through train_state_specs
    for arch in ("gpt-117m", "granite-moe-3b-a800m"):
        c, rc = get_config(arch), ref_get_config(arch)
        for shape_map in ({"data": 2, "model": 2}, *MESHES.values()):
            fm = _FakeMesh(shape_map)
            rplan = ref_sh.make_plan(rc, fm, REF_SHAPES["train_4k"])
            plan = sh.make_plan(c, fm, SHAPES["train_4k"])
            rp, p = _abstract(arch)
            _, rosh = ref_sh.train_state_shardings(
                rplan, rp, {"m": rp, "step": 0}, rc)
            _, osp = sh.train_state_specs(plan, p, {"m": p, "step": 0}, c)
            want = [tuple(s.spec) for s in jax.tree.leaves(
                rosh["m"], is_leaf=lambda x: isinstance(x,
                                                        SimpleNamespace))]
            assert sh._spec_leaves(osp["m"], p) == want, (arch, shape_map)
            assert osp["step"] == ()


def test_batch_specs_and_dp_plans_match_reference(fake_named_sharding):
    for shape_map in ({"data": 4, "model": 1}, {"data": 2, "model": 2},
                      {"pod": 2, "data": 2, "model": 1}):
        fm = _FakeMesh(shape_map)
        rplan, plan = ref_sh.make_dp_plan(fm), sh.make_dp_plan(fm)
        assert (plan.dp, plan.use_tp, plan.tp_size) == \
            (rplan.dp, rplan.use_tp, rplan.tp_size)
        assert sh.dp_size(plan) == ref_sh.dp_size(rplan)
        for shape in ((8, 16), (6, 3), (3, 5), (16,)):
            want = ref_sh.batch_sharding(rplan, shape).spec
            assert sh.batch_spec(plan, shape) == tuple(want), shape


@pytest.mark.parametrize("label", ["dp1", "dp2", "dp4", "dp2tp2", "pp4",
                                   "pod2dp2"])
def test_placement_mesh_axes_match_reference(label):
    p, rp = Placement.of(label), RefPlacement.of(label)
    assert (p.mesh_shape, p.mesh_axes) == (rp.mesh_shape, rp.mesh_axes)


def test_one_rank_mesh_has_no_group():
    m = mesh_mod.mesh_for(Placement.of("dp1"))
    assert (m.rank, m.size, m.coords) == (0, 1, {"data": 0, "model": 0})
    assert m.group(("data",)) is None and m.index("data") == 0
    assert mesh_mod.dp_axes(m) == ("data",)
    assert mesh_mod.axis_size(m, "stage") == 1
    with pytest.raises(ValueError, match="needs 2 ranks, the world has 1"):
        mesh_mod.mesh_for(Placement.of("dp2"))
    plan = sh.make_plan(get_config("gpt-117m").reduced(), m,
                        SHAPES["train_4k"])
    sh.check_executable(plan)
    tp = sh.make_plan(get_config("gpt-117m").reduced(),
                      _FakeMesh({"data": 1, "model": 2}),
                      SHAPES["train_4k"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        sh.check_executable(tp)


def test_mesh_of_ranks_coordinates_and_rows():
    got = mesh_mod.spawn(ranks.mesh_layout, 4, device="cpu")
    assert [g["coords"] for g in got] == [
        {"data": d, "model": 0, "stage": s} for d in (0, 1) for s in (0, 1)]
    assert [g["stage_ranks"] for g in got] == [[0, 1], [0, 1], [2, 3],
                                               [2, 3]]
    assert [g["data_ranks"] for g in got] == [[0, 2], [1, 3], [0, 2],
                                              [1, 3]]
    assert [g["rows"] for g in got] == [[0, 1, 2], [0, 1, 2], [3, 4, 5],
                                        [3, 4, 5]]
    assert [g["sums"] for g in got] == [[1.0, 2.0], [1.0, 4.0],
                                        [5.0, 2.0], [5.0, 4.0]]


RESNET_REF = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.bench.spec import Placement
from repro.configs.resnet50 import CONFIG
from repro.data.synthetic import synthetic_images
from repro.launch.mesh import mesh_for
from repro.models import resnet
from repro.parallel import sharding as shd
from repro.train.optimizer import OptConfig, opt_init
from repro.train.step import make_resnet_train_step

c = CONFIG.reduced(img_size=32, width=8, dtype="float32",
                   param_dtype="float32")
oc = OptConfig(warmup=2, total_steps=1000)
params = jax.jit(resnet.init, static_argnums=1)(jax.random.key(0), c)
opt = opt_init(oc, params)
imgs, labels = synthetic_images(8, c.img_size, c.n_classes)
out = {"params": jax.tree.map(np.asarray, params), "images": imgs,
       "labels": labels}
plan = shd.make_dp_plan(mesh_for(Placement.of("dp2")))
p, o, psh, osh, _ = shd.shard_train_state(plan, params, opt)
step = jax.jit(make_resnet_train_step(c, oc), out_shardings=(psh, osh, None))
batch = {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}
batch = jax.device_put(batch, {k: shd.batch_sharding(plan, v.shape)
                               for k, v in batch.items()})
losses = []
for _ in range(3):
    p, o, m = step(p, o, batch)
    losses.append(float(m["loss"]))
out["losses"] = losses
out["final"] = [np.asarray(x) for x in jax.tree.leaves(p)]
pickle.dump(out, open(PATH, "wb"))
"""


def test_dp2_resnet_with_synced_batchnorm_matches_reference(tmp_path):
    path = tmp_path / "ref.pkl"
    run_in_subprocess(f"PATH = {str(path)!r}\n"
                      + textwrap.dedent(RESNET_REF), n_devices=2)
    with open(path, "rb") as f:
        ref = pickle.load(f)
    got = mesh_mod.spawn(ranks.dp_resnet_steps, 2,
                         args=("dp2", ref["params"], ref["images"],
                               ref["labels"]), device="cpu")
    np.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=1e-4)
    worst = 0.0
    for g, w in zip(got[0]["params"], ref["final"], strict=True):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        worst = max(worst, float(np.abs(g - w).max()))
    assert all(np.array_equal(a, b) for a, b in
               zip(got[0]["params"], got[1]["params"]))
    print(f"\nresnet dp2: losses {got[0]['losses']} vs {ref['losses']}, "
          f"params max |diff| {worst:.3e}")


def test_ranks_join_a_world_from_the_environment(tmp_path):
    """Two processes started as a launcher starts them (``RANK``,
    ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, as
    ``launch/slurm.py``'s scripts set them) train one dp2 run: rank 0
    alone prints the result, and both write nothing but rank 0 the
    checkpoint."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:              # a free port on this host
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH="src", RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--device",
             "cpu", "--placement", "dp2", "--steps", "2", "--seq-len", "16",
             "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    assert "[train] done: steps=2" in outs[0]
    assert "[train] done" not in outs[1]
    assert sorted(os.listdir(tmp_path)) == ["step_2"]
