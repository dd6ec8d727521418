"""The port's pipeline across ranks against ``repro``'s, on the CPU.

The reference runs ``pipeline_forward`` over a 4-stage mesh of forced
host devices in a subprocess (as ``tests/conftest.py::
run_in_subprocess`` runs it) on its tiny fp32 gpt-117m layers (the
``pipeline_gpt`` workload's correctness config); the port runs the
rotation schedule in four gloo ranks on the same weights and inputs
(4 microbatches of 2 x 32 tokens):

  * the pipeline's outputs against the reference's at rtol / atol 1e-5,
    equal on every rank (broadcast from the last stage), and against the
    sequential forward of the same layers at 1e-5 (the reference's
    ``test_pipeline_compress.py:14`` check);
  * ``bubble_fraction`` and ``stage_params_split`` against the
    reference's.
"""
import pickle
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from conftest import run_in_subprocess
from repro.parallel import pipeline as ref_pipeline
from repro_torch.launch import mesh as mesh_mod
from repro_torch.parallel import pipeline

REF = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.bench.workloads.pipeline_gpt import _layer_fn, N_STAGES
from repro.configs import get_config
from repro.data.synthetic import synthetic_tokens
from repro.launch.mesh import make_mesh
from repro.models import lm
from repro.parallel.pipeline import pipeline_forward, stage_params_split

c = get_config("gpt-117m").reduced(n_layers=4, d_model=64, d_ff=128,
                                   n_heads=2, n_kv_heads=2, d_head=32,
                                   vocab=512, dtype="float32",
                                   param_dtype="float32")
mesh = make_mesh((N_STAGES,), ("stage",))
params = lm.init(jax.random.key(0), c)
sp = stage_params_split(params["layers"], N_STAGES)
toks = jnp.asarray(synthetic_tokens(8, 32, c.vocab)[:, :32])
x = lm._inputs_to_embeds(c, params, toks, None)
x_mb = x.reshape(4, 2, 32, c.d_model)
out = pipeline_forward(mesh, "stage", _layer_fn(c), sp, x_mb)
pickle.dump({"params": jax.tree.map(np.asarray, params),
             "x": np.asarray(x_mb), "out": np.asarray(out)},
            open(PATH, "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref_pp") / "ref.pkl"
    run_in_subprocess(f"PATH = {str(path)!r}\n" + textwrap.dedent(REF),
                      n_devices=4)
    with open(path, "rb") as f:
        ref = pickle.load(f)
    got = mesh_mod.spawn(ranks.pipeline_outputs, 4,
                         args=(ref["params"], ref["x"]), device="cpu")
    return ref, got


def test_pipeline_matches_reference_and_sequential(runs):
    ref, got = runs
    out = got[0]["pipeline"]
    assert out.shape == ref["out"].shape == (4, 2, 32, 64)
    np.testing.assert_allclose(out, ref["out"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.reshape(-1, 32, 64), got[0]["sequential"],
                               rtol=1e-5, atol=1e-5)
    for g in got[1:]:
        assert np.array_equal(g["pipeline"], out)
    print(f"\npipeline vs reference max |diff| "
          f"{np.abs(out - ref['out']).max():.3e}")


@pytest.mark.parametrize("stages,mbs", [(4, 8), (4, 4), (2, 16), (1, 3)])
def test_bubble_fraction_matches_reference(stages, mbs):
    assert pipeline.bubble_fraction(stages, mbs) == \
        ref_pipeline.bubble_fraction(stages, mbs)
    assert pipeline.bubble_fraction(4, 8) == 3 / 11


def test_stage_params_split_matches_reference():
    x = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    want = ref_pipeline.stage_params_split({"w": jnp.asarray(x)}, 4)
    got = pipeline.stage_params_split({"w": torch.from_numpy(x)}, 4)
    assert np.array_equal(got["w"].numpy(), np.asarray(want["w"]))
    with pytest.raises(ValueError, match="do not split"):
        pipeline.stage_params_split({"w": torch.zeros(6, 2)}, 4)
