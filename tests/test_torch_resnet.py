"""The port's ResNet path against ``repro``'s, on the CPU.

The same inputs (a numpy seed) and the same weights (the reference's
``resnet.init``, carried across by ``bridge.params_from_numpy``) through
both packages, on fp32 reduced configs:

  * "SAME" convolution over odd and even sizes, k in {1, 3, 7}, stride
    1 and 2, against ``jax.lax.conv_general_dilated``: atol 1e-5 and
    rtol 1e-5 (summation order); the "SAME" max-pool against
    ``reduce_window``: equal (a max rounds nothing);
  * ``batchnorm`` with each epilogue (none, ReLU, the shortcut added
    before the ReLU) against the reference's ``batchnorm`` followed by
    ``jax.nn.relu`` and the add: fp32 at atol 1e-5 (and its gradients
    against ``jax.vjp`` at atol 1e-5, rtol 1e-4), bf16 within one bf16
    ulp of the output (both compute in fp32 and round once; with the
    shortcut, that ulp carried into the sum plus the sum's rounding);
    an epilogue it does not have raises;
  * ``forward`` logits at atol 1e-5, rtol 1e-4;
  * the loss at rtol 1e-6 and every gradient leaf at atol 1e-5, rtol
    1e-4 against ``jax.value_and_grad``;
  * three AdamW steps of ``make_resnet_train_step`` against the
    reference's jitted step: losses at rtol 1e-5, params and optimizer
    state after each step at ``STEP_TOL``;
  * a reference ResNet train state's checkpoint (its list-shaped
    ``stages`` keys) restores in the port bit for bit, and the port's
    in the reference;
  * ``init_train_state``'s tree, shapes and dtypes against the
    reference's ``eval_shape``, and the full config's 161 leaves and
    25,557,032 parameters; ``forward_flops`` against the convolutions
    and the head of the reference's traced forward;
  * the reference's three ResNet cases of ``tests/test_resnet_serve.py``
    on the port (shapes, falling loss, the full config's structure).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as ref_ckpt
from repro.configs import RESNET_REGISTRY as REF_RESNET_REGISTRY
from repro.configs.resnet50 import CONFIG as REF_CONFIG
from repro.data.synthetic import synthetic_images as ref_synthetic_images
from repro.models import resnet as ref_resnet
from repro.train import loss as ref_loss
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch import bridge
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import RESNET_REGISTRY
from repro_torch.configs.resnet50 import CONFIG, ResNetConfig
from repro_torch.core import tree
from repro_torch.data.synthetic import synthetic_images
from repro_torch.models import resnet
from repro_torch.train import loss, optimizer
from repro_torch.train import step as train_step

torch.set_num_threads(1)

F32 = dict(dtype="float32", param_dtype="float32")
#: params, m, v and master after each step: |port - ref| <= atol + rtol
#: |ref| (the test prints its worst case with ``-s``)
STEP_TOL = (1e-5, 1e-4)


def _configs(**kw):
    return REF_CONFIG.reduced(**F32, **kw), CONFIG.reduced(**F32, **kw)


def _ref_init(rc):
    """The reference's params (jitted: its eager init dispatches each
    draw on its own and takes ~10 s)."""
    return jax.jit(ref_resnet.init, static_argnums=1)(jax.random.key(0), rc)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's NCHW view of NHWC (channels_last) memory."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _batch(c, n=4, seed=0):
    imgs, labels = ref_synthetic_images(n, c.img_size, c.n_classes,
                                        seed=seed)
    return ({"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)},
            {"images": torch.from_numpy(imgs),
             "labels": torch.from_numpy(labels)})


def _assert_tree_close(got, want, atol, rtol, what=""):
    """``got`` (tensors) against ``want`` (jax/numpy), leaf for leaf in
    the reference's order; returns the largest |got - want|."""
    want_leaves = jax.tree.leaves(want)
    got_leaves = tree.leaves(got)
    assert len(got_leaves) == len(want_leaves), what
    worst = 0.0
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        g = g.detach().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, what
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=what)
        if g.size:
            worst = max(worst, float(np.abs(g - w).max()))
    return worst


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("size", [9, 12])
def test_same_conv_matches_reference(size, k, stride):
    rng = np.random.default_rng(size * 100 + k * 10 + stride)
    x = rng.standard_normal((2, size, size + 1, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = resnet.conv(_nchw(x), torch.from_numpy(w), stride)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [7, 8, 15, 16])
def test_same_max_pool_matches_reference(size, stride):
    rng = np.random.default_rng(size + stride)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
        (1, stride, stride, 1), "SAME"))
    got = resnet.max_pool(_nchw(x), 3, stride)
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("n, k, stride, pads", [
    (224, 7, 2, (2, 3)),     # the stem
    (112, 3, 2, (0, 1)),     # the max-pool
    (56, 3, 2, (0, 1)),      # stage 2's first 3x3
    (56, 1, 2, (0, 0)),      # a 1x1/2 projection
    (56, 3, 1, (1, 1)),
])
def test_same_pads_are_xlas(n, k, stride, pads):
    assert resnet.same_pads(n, k, stride) == pads


@pytest.mark.parametrize("act", ["none", "relu", "add_relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_reference(dtype, act):
    """The call with its epilogue against the reference's ``batchnorm``
    followed by ``jax.nn.relu`` (and the shortcut's add before it); in
    fp32 the gradients too, against ``jax.vjp``."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 6, 5, 8)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(8).astype(np.float32),
         "bias": rng.standard_normal(8).astype(np.float32)}
    sc = (rng.standard_normal(x.shape) * 2).astype(np.float32) \
        if act == "add_relu" else None
    jdt = jnp.dtype(dtype)

    def ref_fn(q, xx, ss):
        y, _ = ref_resnet.batchnorm(q, xx)
        if ss is not None:
            y = y + ss
        return y if act == "none" else jax.nn.relu(y)

    jp = {k: jnp.asarray(v, jdt) for k, v in p.items()}
    jsc = None if sc is None else jnp.asarray(sc, jdt)
    want, vjp = jax.vjp(ref_fn, jp, jnp.asarray(x, jdt), jsc)
    tdt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(v).to(tdt).requires_grad_(True)
          for k, v in p.items()}
    tx = _nchw(x).to(tdt).requires_grad_(True)
    tsc = None if sc is None else _nchw(sc).to(tdt).requires_grad_(True)
    got = resnet.batchnorm(tp, tx, act=act, residual=tsc)
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        if act == "add_relu":
            # one bf16 ulp of the normalised output (2**-8 relative),
            # carried into the sum, and one of the sum's own rounding
            y, _ = ref_resnet.batchnorm(jp, jnp.asarray(x, jdt))
            bound = 2.0 ** -8 * (np.abs(np.asarray(y, np.float32))
                                 + np.abs(want)) + 1e-6
            assert (np.abs(_nhwc(got) - want) <= bound).all()
        else:    # one bf16 ulp of the output (2**-8 relative)
            np.testing.assert_allclose(_nhwc(got), want, atol=1e-6,
                                       rtol=2.0 ** -8)
        return
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=1e-5)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    wp, wx, wsc = vjp(jnp.asarray(dy))
    torch.autograd.backward(got, _nchw(dy))
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(wx), atol=1e-5,
                               rtol=1e-4)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(wp[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    if sc is not None:
        np.testing.assert_allclose(_nhwc(tsc.grad), np.asarray(wsc),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("act,residual", [("none", True), ("relu", True),
                                          ("add_relu", False),
                                          ("gelu", False)])
def test_batchnorm_refuses_an_epilogue_it_does_not_have(act, residual):
    x = torch.ones(2, 4, 3, 3)
    p = {"scale": torch.ones(4), "bias": torch.zeros(4)}
    with pytest.raises(ValueError):
        resnet.batchnorm(p, x, act=act,
                         residual=torch.ones_like(x) if residual else None)


# ---------------------------------------------------------------------------
# Model, gradients, steps
# ---------------------------------------------------------------------------


def test_forward_logits_match_reference():
    rc, c = _configs()
    rp = _ref_init(rc)
    p = bridge.params_from_numpy(_np(rp), "cpu")
    assert isinstance(p["stages"], list) and isinstance(p["stages"][0], list)
    rb, pb = _batch(c)
    want = np.asarray(jax.jit(ref_resnet.forward, static_argnums=0)(
        rc, rp, rb["images"]))
    got = resnet.forward(c, p, pb["images"])
    assert got.shape == (4, c.n_classes)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-4)


def test_loss_and_gradients_match_reference():
    rc, c = _configs()
    rp = _ref_init(rc)
    p = bridge.params_from_numpy(_np(rp), "cpu")
    rb, pb = _batch(c)

    def ref_fn(q):
        return ref_loss.classification_loss(
            ref_resnet.forward(rc, q, rb["images"]), rb["labels"])

    want_l, want = jax.jit(jax.value_and_grad(ref_fn))(rp)

    def loss_fn(q, batch):
        return loss.classification_loss(
            resnet.forward(c, q, batch["images"]), batch["labels"]), ()

    (got_l, _), grads = train_step.value_and_grad(loss_fn)(p, pb)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)
    worst = _assert_tree_close(grads, want, 1e-5, 1e-4, "grads")
    print(f"\nresnet grads max |diff| {worst:.3e}")
    assert not any(t.requires_grad for t in tree.leaves(p))


def test_resnet_train_steps_match_reference():
    rc, c = _configs()
    kw = dict(warmup=2, total_steps=1000)
    ro_cfg, po_cfg = ref_opt.OptConfig(**kw), optimizer.OptConfig(**kw)
    rp = _ref_init(rc)
    ro = ref_opt.opt_init(ro_cfg, rp)
    p, o = bridge.train_state_from_numpy(_np(rp), _np(ro), device="cpu")
    ref = jax.jit(ref_step.make_resnet_train_step(rc, ro_cfg))
    port = train_step.make_resnet_train_step(c, po_cfg)
    atol, rtol = STEP_TOL
    worst = 0.0
    for i in range(3):
        rb, pb = _batch(c, seed=i)
        rp, ro, rm = ref(rp, ro, rb)
        p2, o2, m = port(p, o, pb)
        assert p2 is p and o2 is o        # updated in place
        for key in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                       rtol=1e-5, err_msg=key)
        assert int(o["step"]) == int(ro["step"]) == i + 1
        worst = max(worst, _assert_tree_close((p, o), (rp, ro), atol, rtol,
                                              f"step {i + 1}"))
    print(f"\nresnet AdamW 3 steps: state max |diff| {worst:.3e}")


def test_init_train_state_matches_reference_structure():
    for ref_c, c in ((REF_CONFIG.reduced(), CONFIG.reduced()),
                     _configs(stage_sizes=(2, 1, 1, 2))):
        oc_ref, oc = ref_opt.OptConfig(), optimizer.OptConfig()
        want = ref_step.init_train_state(ref_c, oc_ref, abstract=True)
        got = train_step.init_train_state(
            c, oc, torch.Generator().manual_seed(0), "cpu")
        want_paths = [jax.tree_util.keystr(k) for k, _ in
                      jax.tree_util.tree_flatten_with_path(want)[0]]
        got_paths = ["".join(f"[{k!r}]" for k in path)
                     for path, _ in tree.paths(got)]
        assert got_paths == want_paths
        for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name


def test_resnet_checkpoints_cross_between_packages(tmp_path):
    rc, c = REF_CONFIG.reduced(), CONFIG.reduced()        # bf16 params
    rp = _ref_init(rc)
    state = _np((rp, ref_opt.opt_init(ref_opt.OptConfig(), rp)))
    ref_ckpt.save(state, tmp_path / "ref", step=2)
    template = train_step.init_train_state(
        c, optimizer.OptConfig(), torch.Generator().manual_seed(1), "cpu")
    got, manifest = ckpt.restore(template, tmp_path / "ref")
    assert "0/stages/1/0/proj" in manifest["leaves"]
    want = bridge.train_state_from_numpy(*state, device="cpu")
    for a, b in zip(tree.leaves(got), tree.leaves(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ckpt.save(got, tmp_path / "port", step=3)
    back, _ = ref_ckpt.restore(jax.tree.map(jnp.zeros_like, state),
                               tmp_path / "port")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_full_config_params_and_flops():
    want = jax.eval_shape(lambda k: ref_resnet.init(k, REF_CONFIG),
                          jax.random.key(0))
    p = resnet.init(CONFIG, torch.Generator().manual_seed(0), "cpu")
    leaves = tree.leaves(p)
    assert [tuple(t.shape) for t in leaves] == \
        [w.shape for w in jax.tree.leaves(want)]
    assert len(leaves) == 161
    assert sum(t.numel() for t in leaves) == 25_557_032
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    # the model's operations from the reference's own traced forward:
    # every convolution and the head, 2 a multiply-add
    jaxpr = jax.make_jaxpr(lambda q, x: ref_resnet.forward(REF_CONFIG, q, x))(
        want, jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))
    flops = 0
    for eqn in jaxpr.jaxpr.eqns:
        out = eqn.outvars[0].aval.shape
        if eqn.primitive.name == "conv_general_dilated":
            kh, kw, cin, _ = eqn.invars[1].aval.shape
            flops += 2 * int(np.prod(out)) * kh * kw * cin
        elif eqn.primitive.name == "dot_general":
            flops += 2 * int(np.prod(out)) * eqn.invars[0].aval.shape[-1]
    assert resnet.forward_flops(CONFIG) == flops == 8_178_368_512


def test_init_draws_the_reference_distributions():
    c = CONFIG.reduced(**F32, width=16)
    p = resnet.init(c, torch.Generator().manual_seed(0), "cpu")
    w = p["stages"][1][0]["conv2"]                   # 3x3, 32 -> 32
    assert abs(w.std().item() / np.sqrt(2.0 / (9 * 32)) - 1) < 0.05
    assert abs(p["head"].std().item() / 0.01 - 1) < 0.05
    assert torch.equal(p["bn_stem"]["scale"], torch.ones(16))
    assert torch.equal(p["head_b"], torch.zeros(c.n_classes))


# ---------------------------------------------------------------------------
# The reference's ResNet cases (tests/test_resnet_serve.py) on the port
# ---------------------------------------------------------------------------


def test_resnet_forward_shapes():
    c = CONFIG.reduced()
    p = resnet.init(c, torch.Generator().manual_seed(0), "cpu")
    imgs, _ = synthetic_images(2, c.img_size, c.n_classes)
    logits = resnet.forward(c, p, torch.from_numpy(imgs))
    assert logits.shape == (2, c.n_classes)
    assert bool(torch.isfinite(logits.float()).all())


def test_resnet_train_step_decreases_loss():
    c = CONFIG.reduced()
    oc = optimizer.OptConfig(lr=1e-2, warmup=1, total_steps=50,
                             weight_decay=0.0)
    p, o = train_step.init_train_state(
        c, oc, torch.Generator().manual_seed(0), "cpu")
    step = train_step.make_resnet_train_step(c, oc)
    imgs, labels = synthetic_images(8, c.img_size, c.n_classes)
    batch = {"images": torch.from_numpy(imgs),
             "labels": torch.from_numpy(labels)}
    losses = []
    for _ in range(8):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]  # memorizes the fixed batch


def test_resnet50_full_config_structure():
    # full ResNet50 has the (3,4,6,3) bottleneck layout = 50 conv layers
    assert CONFIG.stage_sizes == (3, 4, 6, 3)
    n_convs = 1 + sum(3 * n for n in CONFIG.stage_sizes)  # stem + 3/block
    assert n_convs == 49  # + fc = 50
    assert RESNET_REGISTRY["resnet50"] is CONFIG
    assert list(RESNET_REGISTRY) == list(REF_RESNET_REGISTRY)
    for name, cfg in RESNET_REGISTRY.items():
        ref = REF_RESNET_REGISTRY[name]
        assert isinstance(cfg, ResNetConfig) and cfg.name == name
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert dataclasses.asdict(cfg.reduced(img_size=64, width=16)) == \
            dataclasses.asdict(ref.reduced(img_size=64, width=16))
