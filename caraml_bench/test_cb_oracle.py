"""The plain references against the port's train steps at a reduced
float32 size on the CPU: the test of the oracle. (The test imports both;
the references import nothing of the program.)"""
import pytest
import torch

from cb_testkit import CELLS, STAGED, tiny
from cbench import check, runner, spec, weights
from cbench.traffic import Feed


def _readings(cell, seed):
    models = spec.arch_module("models", cell.arch)
    specs = models.leaf_specs(cell.config)
    named = weights.make(specs, seed, "cpu", runner.param_dtype(cell))
    prog = models.Program(cell.config, cell.traffic, named, "cpu")
    got = runner.program_readings(
        prog, Feed(cell.traffic, cell.config, seed, "cpu"), specs, cell,
        seed, "cpu")
    return got, runner.reference_readings(cell, seed, "cpu")


@pytest.mark.parametrize("name", CELLS + list(STAGED))
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, -5])
def test_reference_follows_the_port_in_fp32(name, seed):
    got, ref = _readings(tiny(name, "float32"), seed)
    g = check.gaps(got, ref)
    assert g["loss_gap"] < 1e-5
    assert g["grad_gap"] < 1e-4
    # Adam moves an element by about lr in its first steps whatever the
    # size of its gradient, so an element whose gradient is at fp32
    # round-off (one of a tiny BatchNorm's 8 biases) flips with the
    # order of the sums and moves a small leaf's norm by a few percent
    assert g["change_gap"] < 0.05
    assert got["losses"][2] != got["losses"][0]


@pytest.mark.parametrize("name", CELLS + list(STAGED))
def test_leaves_are_the_ports_tree(name):
    """The benchmark's leaves are the tree the program trains: the
    port's own initializer's, for a kind on one of the port's models
    (its module gives ``port_configs``), and for every kind the tree of
    the optimizer state that the program's first step leaves."""
    cell = tiny(name)
    models = spec.arch_module("models", cell.arch)
    specs = models.leaf_specs(cell.config)
    got = {n: tuple(s) for n, s, *_ in specs}
    if hasattr(models, "port_configs"):
        from repro_torch.train.step import init_train_state
        c, oc = models.port_configs(cell.config, cell.traffic)[:2]
        params, _ = init_train_state(c, oc, torch.Generator().manual_seed(0),
                                     "cpu")
        assert {n: tuple(t.shape) for n, t in
                weights.flat(params).items()} == got
    named = weights.make(specs, 0, "cpu", torch.float32)
    prog = models.Program(cell.config, cell.traffic, named, "cpu")
    prog.step(Feed(cell.traffic, cell.config, 0, "cpu").next())
    for state in (prog.first_moments(), prog.masters()):
        assert {n: tuple(t.shape) for n, t in state.items()} == got


def test_weights_repeat_from_the_seed_and_differ_between_seeds():
    cell = tiny("gpt800m-s2048-gb16", "bfloat16")
    specs = spec.arch_module("models", "lm").leaf_specs(cell.config)
    a = weights.make(specs, 7, "cpu")
    b = weights.make(specs, 7, "cpu")
    c = weights.make(specs, 8, "cpu")
    for n in a:
        assert torch.equal(a[n], b[n]) and not torch.equal(a[n], c[n])
        assert a[n].data_ptr() % 256 == a["embed.tok"].data_ptr() % 256
    tree = weights.nest(a)
    assert weights.flat(tree).keys() == a.keys()
    scale = a["layers.slot0.norm1.scale"].float()
    assert abs(scale.mean().item() - 1.0) < 0.01


def test_nest_makes_lists_of_numbered_keys():
    t = weights.nest({"stages.0.0.w": 1, "stages.0.1.w": 2,
                      "stages.1.0.w": 3, "head": 4})
    assert t == {"stages": [[{"w": 1}, {"w": 2}], [{"w": 3}]], "head": 4}
