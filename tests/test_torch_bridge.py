"""Parameter bridge: reference param trees -> the port's tensors.

Every leaf of the reference's reduced ``lm.init`` (dense, and one
architecture of each of the moe, ssm and hybrid families) crosses with
its shape, dtype and bits intact — bf16 leaves too, through their
uint16 view — and the port's own dense ``lm.init`` builds the same
tree.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import lm

torch.set_num_threads(1)

ARCHS = ["llama3.2-3b", "gpt-800m"]
#: trees that cross the bridge: the dense ones and one of each other
#: family (the port's own init of those is held in test_torch_families)
ROUND_TRIP = ARCHS + ["granite-moe-3b-a800m", "mamba2-1.3b",
                      "jamba-v0.1-52b"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ROUND_TRIP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_leaf_round_trips(arch, dtype):
    c = ref_get_config(arch).reduced(dtype=dtype, param_dtype=dtype)
    tree = jax.tree.map(np.asarray, ref_lm.init(jax.random.key(1), c))
    got = dict(_leaves(params_from_numpy(tree, "cpu")))
    want = dict(_leaves(tree))
    assert got.keys() == want.keys()
    for path, a in want.items():
        t = got[path]
        assert tuple(t.shape) == a.shape, path
        assert t.dtype == DTYPES[a.dtype.name], path
        bits = t.view(torch.int16 if a.itemsize == 2 else torch.int32)
        np.testing.assert_array_equal(
            bits.numpy().view(np.uint8),
            np.ascontiguousarray(a).view(np.uint8))


def test_bridge_casts_on_request():
    c = ref_get_config("llama3.2-3b").reduced()
    tree = jax.tree.map(np.asarray, ref_lm.init(jax.random.key(2), c))
    out = params_from_numpy(tree, "cpu", dtype=torch.float32)
    want = tree["layers"]["slot0"]["attn"]["wq"].astype(np.float32)
    np.testing.assert_array_equal(
        out["layers"]["slot0"]["attn"]["wq"].numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_builds_the_reference_tree(arch):
    ref_c = ref_get_config(arch).reduced()
    c = get_config(arch).reduced()
    want = dict(_leaves(jax.tree.map(np.asarray,
                                     ref_lm.init(jax.random.key(0), ref_c))))
    gen = torch.Generator().manual_seed(0)
    got = dict(_leaves(lm.init(c, gen, "cpu")))
    assert got.keys() == want.keys()
    for path, a in want.items():
        assert tuple(got[path].shape) == a.shape, path
        assert got[path].dtype == DTYPES[a.dtype.name], path
    # same distributions: fan-in scaled normals and unit norm scales
    wq = got[("layers", "slot0", "attn", "wq")].float()
    assert abs(wq.std().item() * c.d_model ** 0.5 - 1.0) < 0.1
    assert (got[("final_norm", "scale")] == 1).all()
