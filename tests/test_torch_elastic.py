"""Elastic rescaling and dp checkpoints, against ``repro``'s, on the CPU.

  * ``plan_rescale`` equal to the reference's (``tests/test_ckpt.py:83``,
    ``tests/test_faults.py:257``, and more placements), its errors
    included;
  * a dp4 run of the train loop checkpoints at step 2 (every rank
    gathers its ZeRO-1 slices, rank 0 writes whole leaves), a dp2 world
    restores it, cuts its own slices and trains on to step 4: its losses
    at rtol 1e-5 and its final params and AdamW state at rtol 1e-4
    (atol 1e-6) against an uninterrupted dp2 run; the checkpoint
    restores in the reference, whole leaves of the reference's shapes;
  * ``reshard_state`` on a world of one.
"""
import jax
import numpy as np
import pytest

import _torch_ranks as ranks
from repro.bench.spec import Placement as RefPlacement
from repro.ckpt import checkpoint as ref_ckpt
from repro.ckpt.elastic import plan_rescale as ref_plan_rescale
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import opt_init as ref_opt_init
from repro_torch import bridge
from repro_torch.bench.spec import Placement
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.elastic import plan_rescale, reshard_state
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import tree
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.train.optimizer import OptConfig, opt_init

CASES = [("granite-8b", "train_4k", (16, 16), 32),
         ("granite-8b", "train_4k", {"dp": 16, "tp": 16}, 32),
         ("gpt-117m", "train_4k", "dp8", 3),
         ("gpt-117m", "decode_32k", (4,), 1),
         ("qwen2-0.5b", "prefill_32k", "dp4tp2", 2)]


@pytest.mark.parametrize("arch,shape,old,lost", CASES)
def test_plan_rescale_matches_reference(arch, shape, old, lost):
    ref_old = RefPlacement.of(old) if isinstance(old, dict) else old
    port_old = Placement.of(old) if isinstance(old, dict) else old
    want = ref_plan_rescale(ref_get_config(arch), REF_SHAPES[shape],
                            ref_old, lost)
    got = plan_rescale(get_config(arch), SHAPES[shape], port_old, lost)
    assert vars(got) == vars(want)


@pytest.mark.parametrize("old,lost,match", [
    ((16, 16), 256 - 8, "not enough devices"),
    ("dp2pp4", 1, "dp/tp placements only"),
    ((2, 2, 2), 1, "ambiguous bare mesh shape")])
def test_plan_rescale_errors_match_reference(old, lost, match):
    for fn, cfg, shapes in ((ref_plan_rescale, ref_get_config, REF_SHAPES),
                            (plan_rescale, get_config, SHAPES)):
        with pytest.raises(ValueError, match=match):
            fn(cfg("granite-8b"), shapes["train_4k"], old, lost)


def test_reshard_state_on_a_world_of_one():
    c = get_config("gpt-117m").reduced()
    plan = plan_rescale(c, SHAPES["train_4k"], "dp2", 1)
    assert plan.new_shape == (1, 1)
    params = lm.init(c, device="cpu")
    o = opt_init(OptConfig(), params)
    mesh, splan, (p2, o2), zero = reshard_state((params, o), c, plan,
                                                SHAPES["train_4k"])
    assert mesh.size == 1 and splan.dp == ("data",) and not zero.sliced
    assert p2 is params
    assert all(a.shape == b.shape for a, b in zip(tree.leaves(o2["m"]),
                                                  tree.leaves(o["m"])))


def test_dp4_checkpoint_restored_at_dp2_continues_the_run(tmp_path):
    rc = ref_get_config("gpt-117m").reduced(dtype="float32",
                                             param_dtype="float32")
    rp = jax.tree.map(np.asarray, ref_lm.init(jax.random.key(0), rc))
    a, b = str(tmp_path / "elastic"), str(tmp_path / "straight")
    first, = mesh_mod.spawn(ranks.train_runs, 4, args=(rp, [(a, 2, 2)]),
                            device="cpu")[0]
    assert first["resumed_from"] is None and len(first["losses"]) == 2
    resumed, straight = mesh_mod.spawn(ranks.train_runs, 2, args=(
        rp, [(a, 4, 2), (b, 4, 2)]), device="cpu")[0]
    assert resumed["resumed_from"] == 2 and straight["resumed_from"] is None
    np.testing.assert_allclose(first["losses"], straight["losses"][:2],
                               rtol=1e-5)
    np.testing.assert_allclose(resumed["losses"], straight["losses"][2:],
                               rtol=1e-5)
    # the final states, whole leaves, restored on one process
    p = bridge.params_from_numpy(rp, device="cpu")
    template = (p, opt_init(OptConfig(warmup=2, total_steps=100), p))
    (pa, oa), ma = ckpt.restore(template, a)
    (pb, ob), mb = ckpt.restore(template, b)
    assert ma["step"] == mb["step"] == 4
    for x, y in zip(tree.leaves((pa, oa)), tree.leaves((pb, ob))):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-6)
    # the dp4 world's checkpoint restores in the reference, whole
    ro = ref_opt_init(RefOptConfig(warmup=2, total_steps=100), rp)
    (rp2, ro2), rman = ref_ckpt.restore((rp, ro), a, step=2)
    assert rman["step"] == 2
    assert [np.shape(x) for x in jax.tree.leaves(ro2)] == \
        [np.shape(x) for x in jax.tree.leaves(ro)]
