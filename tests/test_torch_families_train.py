"""Training the moe, ssm and hybrid families: the port against the
reference, on the CPU, and the launchers.

Reduced fp32 granite-moe-3b-a800m, mamba2-1.3b, jamba-v0.1-52b (its
learned-position table cut to 1024 rows in both packages, as in
test_torch_families.py) and llama4-maverick-400b-a17b, the reference's
weights bridged, the same numpy batches:

  * the loss (cross-entropy plus ``router_aux_coef`` times the summed MoE
    aux), and every gradient leaf at 1e-4 of the leaf's largest gradient
    (a mamba leaf's gradient sums over the sequence with cancellation:
    see tests/test_torch_ssm.py), against ``jax.value_and_grad``;
  * three AdamW steps against the reference's jitted step: losses at
    rtol 1e-5, params and optimizer state after each step within
    ``STEP_TOL`` (the params' worst is printed with ``-s``);
  * ``python -m repro_torch.launch.serve`` and ``...launch.train`` with
    ``--arch <family> --preset tiny --device cpu`` (their ``main``, in
    process).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch import bridge
from repro_torch.core import tree
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.train import optimizer
from repro_torch.train import step as train_step
from test_torch_families import ARCHS, configs

torch.set_num_threads(1)

#: |port - ref| <= atol + rtol |ref| after each of three AdamW steps
#: (lr 3e-4 after a 2-step warmup). Moments: atol 1e-6 (measured worst:
#: m 8.5e-8, v 4.2e-9). Params and master weights: a tenth of the peak
#: lr. AdamW moves a param by lr * m / (sqrt(v) + eps), about +-lr
#: whatever the gradient's size, so an element whose gradient is near
#: zero, where the two packages' fp32 sums differ in the 5th digit,
#: moves by a different fraction of lr (measured worst 1.58e-5, jamba;
#: 5.2e-6 mamba2, 3.8e-6 llama4, 1.3e-6 granite-moe).
STEP_TOL = {"params": (3e-5, 1e-5), "master": (3e-5, 1e-5),
            "m": (1e-6, 1e-5), "v": (1e-6, 1e-5)}


def _batch(c, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, c.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    rc, c = configs(request.param)
    rp = ref_lm.init(jax.random.key(0), rc)
    return rc, c, rp


def test_loss_and_gradients(models):
    rc, c, rp = models
    p = bridge.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, rc.vocab, (2, 32)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    ref_fn = ref_step.make_loss_fn(rc, ref_step.StepConfig())
    (wl, (wce, waux)), want = jax.jit(jax.value_and_grad(
        lambda q: ref_fn(q, {"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(labels)}),
        has_aux=True))(rp)
    vg = train_step.value_and_grad(train_step.make_loss_fn(
        c, train_step.StepConfig()))
    (l, (ce, aux)), grads = vg(p, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(l), float(wl), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(wce), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-4, atol=1e-6)
    want_leaves = jax.tree.leaves(want)
    got_leaves = tree.leaves(grads)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-6))


def test_adamw_steps_match_reference(models):
    rc, c, rp = models
    kw = dict(name="adamw", warmup=2, total_steps=100)
    ro_cfg, po_cfg = ref_opt.OptConfig(**kw), optimizer.OptConfig(**kw)
    ro = ref_opt.opt_init(ro_cfg, rp)
    p, o = bridge.train_state_from_numpy(jax.tree.map(np.asarray, rp),
                                         jax.tree.map(np.asarray, ro),
                                         device="cpu")
    ref = jax.jit(ref_step.make_train_step(rc, ro_cfg, ref_step.StepConfig()))
    port = train_step.make_train_step(c, po_cfg, train_step.StepConfig())
    worst = 0.0
    losses = []
    for i in range(3):
        rb, pb = _batch(c, seed=10 + i)
        rp, ro, rm = ref(rp, ro, rb)
        p, o, m = port(p, o, pb)
        for key in ("loss", "ce", "aux", "gnorm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        losses.append(float(m["loss"]))
        assert int(o["step"]) == int(ro["step"]) == i + 1
        for name, (atol, rtol) in STEP_TOL.items():
            got, want = (p, rp) if name == "params" else (o[name], ro[name])
            for g, w in zip(tree.leaves(got), jax.tree.leaves(want),
                            strict=True):
                g, w = g.numpy(), np.asarray(w)
                np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                           err_msg=f"{name} step {i + 1}")
                if name == "params" and g.size:
                    worst = max(worst, float(np.abs(g - w).max()))
    assert np.isfinite(losses).all()
    print(f"\n{c.name}: 3 AdamW steps, losses {losses}, params max |diff| "
          f"{worst:.3e}")


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_the_family(arch, capsys):
    out = serve_cli.main(["--arch", arch, "--preset", "tiny", "--device",
                          "cpu", "--mode", "continuous", "--cache", "paged",
                          "--requests", "3", "--prompt-len", "16",
                          "--gen", "6", "--slots", "2"])
    assert out.summary.n_requests == 3
    assert all(r.finish_reason == "length" for r in out.results)
    res = train_cli.main(["--arch", arch, "--preset", "tiny", "--device",
                          "cpu", "--steps", "3", "--global-batch", "2",
                          "--seq-len", "32"])
    assert res.steps_run == 3 and np.isfinite(res.losses).all()
    text = capsys.readouterr().out
    assert f"arch={arch}-reduced" in text and "[train] done" in text
