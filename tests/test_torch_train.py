"""The port's training path against ``repro``'s, on the CPU.

Reduced fp32 configs (``.reduced(dtype="float32",
param_dtype="float32")``), the same weights (the reference's, bridged)
and the same batches (a numpy seed) through both packages:

  * ``next_token_loss`` (IGNORE labels, a padded vocabulary, z-loss) and
    ``classification_loss`` at rtol 1e-6; the LR schedule and the global
    norm clip at rtol 1e-6;
  * gradients of the gpt-117m and llama3.2-3b reduced losses against
    ``jax.grad`` of the reference's at rtol 1e-4 / atol 1e-6, with full
    remat and without (the port's two give equal bits);
  * three ``make_train_step`` steps (k = 1 and 4 microbatches, fp32 and
    bf16 gradient buffers) for AdamW and Adafactor against the
    reference's jitted step: losses at rtol 1e-5, params and optimizer
    state after each step at atol 1e-6 + rtol 1e-5 (fp32 gradient
    buffers) and atol 2e-5 (bf16 buffers; measured worst case beside
    ``STEP_TOL``);
  * the one-device grad-sync step (``make_dp_train_step``, fp32 and int8
    buckets, overlap on and off, k = 1 and 4) against the reference's on
    a one-device mesh, error-feedback states included; bucketing in the
    reference's leaf order, ``compressed_psum`` on equal inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench.spec import Placement as RefPlacement
from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import mesh_for
from repro.models import lm as ref_lm
from repro.parallel import grad_sync as ref_gs
from repro.parallel import sharding as ref_shd
from repro.parallel.compat import shard_map
from repro.parallel.compress import compressed_psum as ref_compressed_psum
from repro.parallel.compress import quantize_int8 as ref_quantize_int8
from repro.train import loss as ref_loss
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.models import lm
from repro_torch.parallel import compress
from repro_torch.parallel import grad_sync as gs
from repro_torch.train import loss, optimizer
from repro_torch.train import step as train_step

torch.set_num_threads(1)

#: params and optimizer state after each step, per grad buffer dtype:
#: |port - ref| <= atol + rtol |ref|. fp32 buffers at the target (atol
#: 1e-6, rtol 1e-5; measured worst 9.7e-7). bf16 buffers: a gradient
#: element that the two packages round to neighbouring bf16 values
#: (2**-8 apart) moves m by 0.1 of that and the param by up to a step's
#: normalized update times lr: atol 2e-5, measured worst 7.0e-6 (AdamW
#: k=1). The test prints its worst case (``-s``).
STEP_TOL = {"float32": (1e-6, 1e-5), "bfloat16": (2e-5, 1e-5)}


def _configs(arch: str, **kw):
    f32 = dict(dtype="float32", param_dtype="float32", **kw)
    return ref_get_config(arch).reduced(**f32), get_config(arch).reduced(**f32)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _batch(c, b=4, s=16, seed=0, ignore=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, c.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    if ignore:
        labels[:, -1] = loss.IGNORE
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _assert_tree_close(got, want, atol, rtol, what=""):
    """``got`` (tensors) against ``want`` (jax/numpy), leaf for leaf in
    the reference's order, same shapes and dtypes; returns the largest
    |got - want| (printed by the tests that widen a tolerance: ``-s``)."""
    want_leaves = jax.tree.leaves(want)
    got_leaves = tree.leaves(got)
    assert len(got_leaves) == len(want_leaves)
    worst = 0.0
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        g = g.detach().float().numpy() if g.dtype == torch.bfloat16 \
            else g.detach().numpy()
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w.astype(g.dtype), atol=atol,
                                   rtol=rtol, err_msg=what)
        if g.size:
            worst = max(worst, float(np.abs(g - w.astype(g.dtype)).max()))
    return worst


# ---------------------------------------------------------------------------
# Loss, schedule, clip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("z_coef", [0.0, 1e-4])
def test_next_token_loss_matches_reference(z_coef):
    rc, c = _configs("gpt-117m", vocab=500)       # padded to 512
    assert c.padded_vocab == 512 != c.vocab
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, c.padded_vocab)) * 3).astype(
        np.float32)
    logits[..., c.vocab:] = np.finfo(np.float32).min
    labels = rng.integers(0, c.vocab, (3, 7)).astype(np.int32)
    labels[0, :3] = loss.IGNORE
    labels[2, 5] = loss.IGNORE
    want = float(ref_loss.next_token_loss(rc, jnp.asarray(logits),
                                          jnp.asarray(labels), z_coef))
    got = float(loss.next_token_loss(c, torch.from_numpy(logits),
                                     torch.from_numpy(labels), z_coef))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # every label masked: the denominator clamps to 1, the loss is 0
    none = np.full_like(labels, loss.IGNORE)
    assert float(loss.next_token_loss(c, torch.from_numpy(logits),
                                      torch.from_numpy(none))) == 0.0


def test_classification_loss_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    want = float(ref_loss.classification_loss(jnp.asarray(logits),
                                              jnp.asarray(labels)))
    got = float(loss.classification_loss(torch.from_numpy(logits),
                                         torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_lr_schedule_and_clip_match_reference():
    kw = dict(lr=3e-4, warmup=7, total_steps=50, min_lr_frac=0.1)
    ro, po = ref_opt.OptConfig(**kw), optimizer.OptConfig(**kw)
    for s in range(0, 60):
        want = float(ref_opt.lr_at(ro, jnp.asarray(s, jnp.int32)))
        got = optimizer.lr_at(po, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((5, 4)).astype(np.float32),
         "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        want, wn = ref_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                               max_norm)
        got, gn = optimizer.clip_by_global_norm(
            bridge.params_from_numpy(g, "cpu"), max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        _assert_tree_close(got, want, 0, 1e-6)


# ---------------------------------------------------------------------------
# Forward and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gpt-117m", "llama3.2-3b"])
def test_gradients_match_reference(arch):
    rc, c = _configs(arch)
    rp = ref_lm.init(jax.random.key(0), rc)
    p = bridge.params_from_numpy(_np(rp), "cpu")
    rb, pb = _batch(c)
    ref_fn = ref_step.make_loss_fn(rc, ref_step.StepConfig())
    (want_l, (want_ce, _)), want = jax.value_and_grad(
        lambda q: ref_fn(q, rb), has_aux=True)(rp)
    grads = {}
    for remat in ("full", "none"):
        vg = train_step.value_and_grad(train_step.make_loss_fn(
            c, train_step.StepConfig(remat=remat)))
        (l, (ce, aux)), grads[remat] = vg(p, pb)
        np.testing.assert_allclose(float(l), float(want_l), rtol=1e-6)
        np.testing.assert_allclose(float(ce), float(want_ce), rtol=1e-6)
        assert float(aux) == 0.0
        _assert_tree_close(grads[remat], want, 1e-6, 1e-4, remat)
    # recomputation replays the same ops: equal bits
    for a, b in zip(tree.leaves(grads["full"]), tree.leaves(grads["none"])):
        assert torch.equal(a, b)
    # the caller's tensors keep their flags
    assert not any(t.requires_grad for t in tree.leaves(p))


def test_training_forward_matches_the_serving_prefill():
    """``lm.forward`` (the training path, no caches) gives the logits
    ``lm.prefill`` (``stack_prefill``) gives at the last position (the
    prefill unembeds that position alone, so the last matmul's shape and
    with it its summation differ: rtol 1e-5)."""
    _, c = _configs("llama3.2-3b")
    p = lm.init(c, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, c.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    full, aux = lm.forward(c, p, toks)
    last, _, _ = lm.prefill(c, p, toks)
    torch.testing.assert_close(full[:, -1:], last, rtol=1e-5, atol=1e-6)
    assert float(aux) == 0.0


def test_forward_options_that_are_not_ported_raise():
    _, c = _configs("gpt-117m")
    p = lm.init(c, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        lm.forward(c, p, toks, remat="dots")
    with pytest.raises(NotImplementedError, match="repeat"):
        lm.forward(c, p, toks, impl="grouped")
    with pytest.raises(ValueError, match="remat"):
        lm.forward(c, p, toks, remat="some")
    with pytest.raises(TypeError, match="ResNetConfig"):
        train_step.init_train_state(object(), optimizer.OptConfig(),
                                    device="cpu")


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def _bridged_state(rp, ro, rs=None):
    return bridge.train_state_from_numpy(
        _np(rp), _np(ro), None if rs is None else np.asarray(rs),
        device="cpu")


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_steps_match_reference(name, k, grad_dtype):
    rc, c = _configs("gpt-117m")
    kw = dict(name=name, warmup=2, total_steps=100)
    ro_cfg, po_cfg = ref_opt.OptConfig(**kw), optimizer.OptConfig(**kw)
    rp = ref_lm.init(jax.random.key(0), rc)
    ro = ref_opt.opt_init(ro_cfg, rp)
    p, o = _bridged_state(rp, ro)
    assert o["step"].dtype == torch.int32 and o["step"].ndim == 0
    ref = jax.jit(ref_step.make_train_step(
        rc, ro_cfg, ref_step.StepConfig(microbatches=k,
                                        grad_dtype=grad_dtype)))
    port = train_step.make_train_step(
        c, po_cfg, train_step.StepConfig(microbatches=k,
                                         grad_dtype=grad_dtype))
    atol, rtol = STEP_TOL[grad_dtype]
    worst = 0.0
    for i in range(3):
        rb, pb = _batch(c, seed=i)
        rp, ro, rm = ref(rp, ro, rb)
        p2, o2, m = port(p, o, pb)
        assert p2 is p and o2 is o        # updated in place
        for key in ("loss", "ce", "gnorm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                       rtol=1e-5, err_msg=key)
        assert int(o["step"]) == int(ro["step"]) == i + 1
        worst = max(worst, _assert_tree_close((p, o), (rp, ro), atol, rtol,
                                              f"step {i + 1}"))
    print(f"\n{name} k={k} {grad_dtype}: state max |diff| {worst:.3e}")


@pytest.mark.parametrize("piece", [1, 37, 1000])
def test_adamw_update_in_pieces_matches_whole_leaves(monkeypatch, piece):
    """AdamW over leaves split into pieces of at most ``piece`` elements
    (fp32 and bf16 params, a 0-d leaf, rows wider than a piece) is the
    whole-leaf update to the bit, and the reference's at the step
    tolerance."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5, 8), "b": (7, 3), "s": (), "e": (2, 600)}
    rp = {k: jnp.asarray(rng.normal(size=s).astype(np.float32),
                         jnp.bfloat16 if k == "w" else jnp.float32)
          for k, s in shapes.items()}
    rg = {k: jnp.asarray(rng.normal(size=s).astype(np.float32))
          for k, s in shapes.items()}
    oc = dict(warmup=1, total_steps=100)
    ro_cfg = ref_opt.OptConfig(**oc)
    ro = ref_opt.opt_init(ro_cfg, rp)
    grads = bridge.params_from_numpy(_np(rg), "cpu")
    runs = {}
    for n in (optimizer.UPDATE_PIECE, piece):
        monkeypatch.setattr(optimizer, "UPDATE_PIECE", n)
        p, o = _bridged_state(rp, ro)
        for _ in range(3):
            optimizer.adamw_update(optimizer.OptConfig(**oc), grads, o, p)
        runs[n] = (p, o)
    for a, b in zip(tree.leaves(runs[optimizer.UPDATE_PIECE]),
                    tree.leaves(runs[piece]), strict=True):
        assert torch.equal(a, b)
    for _ in range(3):
        rp, ro, _ = ref_opt.adamw_update(ro_cfg, rg, ro, rp)
    _assert_tree_close(runs[piece], (rp, ro), *STEP_TOL["float32"],
                       f"piece {piece}")


def test_opt_init_matches_reference_structure():
    rc, c = _configs("gpt-117m")
    rp = ref_lm.init(jax.random.key(0), rc)
    p = bridge.params_from_numpy(_np(rp), "cpu")
    for name in ("adamw", "adafactor"):
        want = ref_opt.opt_init(ref_opt.OptConfig(name=name), rp)
        got = optimizer.opt_init(optimizer.OptConfig(name=name), p)
        _assert_tree_close(got, want, 0, 0, name)
    # the master copy owns its memory even where params are fp32
    got = optimizer.opt_init(optimizer.OptConfig(), p)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        tree.leaves(got["master"]), tree.leaves(p)))


# ---------------------------------------------------------------------------
# Gradient sync (one device)
# ---------------------------------------------------------------------------


def test_grad_sync_config_and_default():
    with pytest.raises(ValueError, match="grad_sync mode"):
        gs.GradSyncConfig(mode="fp16")
    ref, got = ref_gs.default_sync("int8"), gs.default_sync("int8", "cpu")
    assert (got.mode, got.bucket_mb, got.overlap) == \
        (ref.mode, ref.bucket_mb, ref.overlap) == ("int8", 4.0, False)
    assert gs.GradSyncConfig(bucket_mb=0.001).bucket_elems == \
        ref_gs.GradSyncConfig(bucket_mb=0.001).bucket_elems == 262


def test_flatten_buckets_follow_the_reference_order():
    rng = np.random.default_rng(4)
    t = {"b": rng.standard_normal((3, 5)).astype(np.float32),
         "a": {"z": np.arange(7, dtype=np.float32),
               "y": rng.standard_normal(4).astype(np.float32)},
         "c": np.float32(2.5)}
    want, _ = ref_gs.flatten_buckets(jax.tree.map(jnp.asarray, t), 6)
    pt = bridge.params_from_numpy(t, "cpu")
    pt["b"] = pt["b"].to(torch.bfloat16)
    got, meta = gs.flatten_buckets(pt, 6)
    assert got.shape == (len(want), 6) == (gs.n_buckets(pt, 6), 6)
    ref_t = dict(t, b=np.asarray(jnp.asarray(t["b"], jnp.bfloat16),
                                 np.float32))
    want, _ = ref_gs.flatten_buckets(jax.tree.map(jnp.asarray, ref_t), 6)
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([np.asarray(b) for b in want]))
    back = gs.unflatten_buckets(got, meta)
    for a, b in zip(tree.leaves(back), tree.leaves(pt)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_int8_compression_matches_reference_on_equal_inputs():
    """Same buckets and error state into both, three rounds of error
    feedback: codes, scales and sums agree at rtol 1e-6, residuals at
    atol 1e-6 + 1e-6 x the bucket's largest value. Under jit the
    reference's ``/ 127`` becomes a multiply by the reciprocal, an ulp
    off the port's division, and a residual is ``x - q * scale`` with
    ``q * scale`` near ``x``: a few ulps of the bucket's largest values
    (measured worst 1.43e-6 in buckets reaching ~30; printed, ``-s``)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4096) * 0.3).astype(np.float32)
    q, s = compress.quantize_int8(torch.from_numpy(x))
    rq, rs = ref_quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(s), float(rs), rtol=1e-7)
    mesh = mesh_for(RefPlacement.of("dp1"))
    ax = mesh.axis_names[0]
    from jax.sharding import PartitionSpec as P
    ref = jax.jit(shard_map(lambda b, e: ref_compressed_psum(b[0], ax, e[0]),
                            mesh=mesh, in_specs=(P(ax), P(ax)),
                            out_specs=(P(), P()), check_vma=False))
    buckets = (rng.standard_normal((5, 1000))
               * np.logspace(-4, 1, 5)[:, None]).astype(np.float32)
    err = np.zeros_like(buckets)
    want_err = err.copy()
    worst = 0.0
    for _ in range(3):
        out, new_err = compress.compressed_psum(torch.from_numpy(buckets),
                                                torch.from_numpy(err))
        for i in range(len(buckets)):
            wo, we = ref(buckets[i][None], want_err[i][None])
            np.testing.assert_allclose(out[i].numpy(), np.asarray(wo),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(
                new_err[i].numpy(), np.asarray(we), rtol=0,
                atol=1e-6 + 1e-6 * np.abs(buckets[i]).max())
            want_err[i] = np.asarray(we)
        worst = max(worst, float(np.abs(new_err.numpy() - want_err).max()))
        err = new_err.numpy()
    print(f"\ncompressed_psum residuals: max |diff| {worst:.3e}")


@pytest.fixture(scope="module")
def ref_plan():
    rc, _ = _configs("gpt-117m")
    mesh = mesh_for(RefPlacement.of("dp1"))
    return ref_shd.make_plan(rc, mesh, ShapeConfig("t", 0, 0, "train"))


#: the dp step against the reference's, three steps of 8 x 16 tokens:
#: losses at rtol 1e-5; params and optimizer state at atol DP_TOL + rtol
#: 1e-5. fp32 buckets (the sync is the identity): atol 2e-6, measured
#: worst 1.47e-6. int8 buckets: a gradient that the packages compute an
#: ulp apart can round to the neighbouring int8 code (measured 7-28 of
#: 91,735 codes flipped over three steps); such a code's residual
#: differs by one quantization step of its bucket and its param by up to
#: lr: atol 1e-4, measured worst 3.27e-5. The error states agree at
#: atol 1e-6 everywhere but the flipped codes, at most 1e-3 of them.
DP_TOL = {"fp32": 2e-6, "int8": 1e-4}


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_dp_train_step_matches_reference(ref_plan, mode, overlap, k):
    rc, c = _configs("gpt-117m")
    oc = dict(warmup=2, total_steps=100)
    rp = ref_lm.init(jax.random.key(0), rc)
    ro = ref_opt.opt_init(ref_opt.OptConfig(**oc), rp)
    rsync = ref_gs.GradSyncConfig(mode=mode, bucket_mb=0.01,
                                  overlap=overlap)
    ref = jax.jit(ref_gs.make_dp_train_step(
        rc, ref_opt.OptConfig(**oc), ref_step.StepConfig(microbatches=k),
        plan=ref_plan, sync=rsync))
    rs = ref_gs.init_sync_state(ref_plan, rp, rsync)
    p, o, s = _bridged_state(rp, ro, rs)
    sync = gs.GradSyncConfig(mode=mode, bucket_mb=0.01, overlap=overlap)
    assert s.shape == gs.init_sync_state(p, sync).shape
    port = gs.make_dp_train_step(c, optimizer.OptConfig(**oc),
                                 train_step.StepConfig(microbatches=k),
                                 sync=sync)
    for i in range(3):
        rb, pb = _batch(c, b=8, seed=10 + i, ignore=False)
        rp, ro, rs, rm = ref(rp, ro, rs, rb)
        p, o, s, m = port(p, o, s, pb)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-5)
    worst = _assert_tree_close((p, o), (rp, ro), DP_TOL[mode], 1e-5)
    flipped = np.zeros(0, bool)
    if mode == "int8":
        diff = np.abs(s.numpy() - np.asarray(rs))
        flipped = diff > 1e-6
        assert flipped.mean() <= 1e-3, flipped.sum()
    print(f"\ndp {mode} overlap={overlap} k={k}: state max |diff| "
          f"{worst:.3e}, error-state codes flipped {int(flipped.sum())} "
          f"of {flipped.size}")
