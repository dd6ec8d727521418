"""The encdec (whisper-small) and vlm (llava-next-34b) families: the
port's model stack against the reference's, on the CPU.

Reduced fp32 configs, the reference's weights (``lm.init``, bridged) and
the same seeded numpy inputs through both packages. The side inputs are
seeded random (zeros, what the reference's launchers feed, would hide a
wrong transpose):

  * the port's own ``lm.init`` builds the reference's tree (the
    ``encoder`` subtree, the decoder's ``norm_x``/``cross`` slots);
  * ``encode`` and its per-layer cross K/V, ``cross_attention`` and the
    vlm's patch prefix at 1e-5;
  * ``forward``, ``prefill`` (caches and cross K/V too) and shared-
    position ``decode_step`` logits at 1e-4; a vlm decodes at
    ``n_patches + S``;
  * ``forward`` gradients at 1e-4 and three AdamW steps;
  * a whisper train state crosses the bridge leaf for leaf in the
    reference's tree order, and its checkpoints restore in the other
    package bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import lm as ref_lm
from repro.serve.cache import grow_caches as ref_grow
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch import bridge
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.models import attention, lm
from repro_torch.serve.cache import grow_caches
from repro_torch.train import optimizer
from repro_torch.train import step as train_step
from test_torch_families import _close, _leaves, ref_init
from test_torch_families_train import STEP_TOL

torch.set_num_threads(1)

ARCHS = ["whisper-small", "llava-next-34b"]
OP_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(arch, **over):
    kw = {"dtype": "float32", "param_dtype": "float32", **over}
    return ref_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def side_inputs(c, b, seed):
    """A vlm's patch embeddings or an encdec's frames, seeded random,
    as (reference kwargs, port kwargs)."""
    rng = np.random.default_rng(seed)
    key, n = {"vlm": ("patch_embeds", c.n_patches),
              "encdec": ("enc_frames", c.enc_seq)}[c.family]
    x = rng.standard_normal((b, n, c.d_model)).astype(np.float32)
    return {key: jnp.asarray(x)}, {key: torch.from_numpy(x)}


def tokens(c, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, c.vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    rc, c = configs(request.param)
    rp = ref_init(rc)
    p = bridge.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rc, c, rp, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_builds_the_reference_tree(arch, dtype):
    rc, c = configs(arch, dtype=dtype, param_dtype=dtype)
    want = dict(_leaves(ref_lm.init_abstract(rc)))
    got = dict(_leaves(lm.init(c, torch.Generator().manual_seed(0), "cpu")))
    assert got.keys() == want.keys()
    for path, a in want.items():
        assert tuple(got[path].shape) == a.shape, path
        assert got[path].dtype == DTYPES[np.dtype(a.dtype).name], path
    assert c.param_count() == rc.param_count()
    if c.family == "encdec":
        assert {"norm_x", "cross"} <= set(
            k[2] for k in want if k[0] == "layers")
        assert got["encoder", "pos"].shape == (c.enc_seq, c.d_model)
        assert got["encoder", "layers", "attn", "wq"].shape[0] == \
            c.n_enc_layers


def test_encode_and_cross_attention():
    rc, c, rp, p = _whisper()
    rkw, kw = side_inputs(c, 2, seed=1)
    want_out, want_kv = jax.jit(ref_lm.encode, static_argnums=0)(
        rc, rp, rkw["enc_frames"])
    got_out, got_kv = lm.encode(c, p, kw["enc_frames"])
    _close(got_out, want_out, OP_TOL)
    for (path, w), (gpath, g) in zip(_leaves(want_kv), _leaves(got_kv),
                                     strict=True):
        assert path == gpath
        _close(g, w, OP_TOL)
    x = np.random.default_rng(2).standard_normal(
        (2, 5, c.d_model)).astype(np.float32)
    sp = jax.tree.map(lambda a: a[0], rp["layers"]["slot0"]["cross"])
    ekv = (want_kv["slot0"]["k"][0], want_kv["slot0"]["v"][0])
    want = ref_attn.cross_attention(rc, sp, jnp.asarray(x), ekv)
    got = attention.cross_attention(
        c, tree.tree_map(lambda t: t[0], p["layers"]["slot0"]["cross"]),
        torch.from_numpy(x), (got_kv["slot0"]["k"][0],
                              got_kv["slot0"]["v"][0]))
    _close(got, want, OP_TOL)


def test_vlm_patch_prefix():
    rc, c = configs("llava-next-34b")
    rp = ref_init(rc)
    p = bridge.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    tok = tokens(c, 2, 12, seed=3)
    rkw, kw = side_inputs(c, 2, seed=4)
    want = ref_lm._inputs_to_embeds(rc, rp, jnp.asarray(tok),
                                    rkw["patch_embeds"])
    got = lm._inputs_to_embeds(c, p, torch.from_numpy(tok),
                               kw["patch_embeds"])
    assert got.shape == (2, c.n_patches + 12, c.d_model)
    _close(got, want, OP_TOL)
    torch.testing.assert_close(got[:, :c.n_patches], kw["patch_embeds"])


def _whisper():
    rc, c = configs("whisper-small")
    rp = ref_init(rc)
    return rc, c, rp, bridge.params_from_numpy(jax.tree.map(np.asarray, rp),
                                               "cpu")


def test_forward_logits(models):
    rc, c, rp, p = models
    tok = tokens(c, 2, 24, seed=5)
    rkw, kw = side_inputs(c, 2, seed=6)
    want, _ = jax.jit(ref_lm.forward, static_argnums=0)(
        rc, rp, jnp.asarray(tok), **rkw)
    got, aux = lm.forward(c, p, torch.from_numpy(tok), **kw)
    assert got.shape == (2, 24, c.padded_vocab)    # text positions only
    _close(got, want)
    assert float(aux) == 0.0


def test_prefill_then_shared_position_decode(models):
    """``prefill`` (logits, caches, cross K/V), then four decode steps at
    one position shared by the batch, from the prefill cache's length
    (patches plus text for the vlm), against the reference's ops at the
    same positions."""
    rc, c, rp, p = models
    b, s, steps = 2, 20, 4
    tok = tokens(c, b, s, seed=7)
    rkw, kw = side_inputs(c, b, seed=8)
    want, jcaches, jekv = jax.jit(ref_lm.prefill, static_argnums=0)(
        rc, rp, jnp.asarray(tok), **rkw)
    with torch.no_grad():
        got, caches, ekv = lm.prefill(c, p, torch.from_numpy(tok), **kw)
    _close(got, want)
    for (path, w), (gpath, g) in zip(_leaves(jcaches), _leaves(caches),
                                     strict=True):
        assert path == gpath
        _close(g, w)
    assert (ekv is None) == (jekv is None) == (c.family == "vlm")
    n = s + (c.n_patches if c.family == "vlm" else 0)
    assert caches["slot0"]["k"].shape[2] == n
    jcaches = ref_grow(jcaches, n + steps)
    caches = grow_caches(caches, n + steps)
    ref_decode = jax.jit(ref_lm.decode_step, static_argnums=0)
    nxt = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)
    for i in range(steps):
        want, jcaches = ref_decode(rc, rp, jnp.asarray(nxt[:, None]),
                                   jcaches, jnp.int32(n + i), enc_kv=jekv)
        with torch.no_grad():
            got, caches = lm.decode_step(
                c, p, torch.from_numpy(nxt[:, None].astype(np.int64)),
                caches, n + i, enc_kv=ekv)
        _close(got, want)
        nxt = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)


def _batches(c, i, b=2, s=24):
    tok = tokens(c, b, s + 1, seed=20 + i)
    rkw, kw = side_inputs(c, b, seed=30 + i)
    rb = {"tokens": jnp.asarray(tok[:, :-1]),
          "labels": jnp.asarray(tok[:, 1:]), **rkw}
    pb = {"tokens": torch.from_numpy(tok[:, :-1]),
          "labels": torch.from_numpy(tok[:, 1:]), **kw}
    return rb, pb


def test_forward_gradients(models):
    rc, c, rp, p = models
    rb, pb = _batches(c, 0)
    ref_fn = ref_step.make_loss_fn(rc, ref_step.StepConfig())
    (wl, _), want = jax.jit(jax.value_and_grad(
        lambda q: ref_fn(q, rb), has_aux=True))(rp)
    vg = train_step.value_and_grad(train_step.make_loss_fn(
        c, train_step.StepConfig()))
    (l, _), grads = vg(p, pb)
    np.testing.assert_allclose(float(l), float(wl), rtol=1e-5)
    got = tree.leaves(grads)
    assert len(got) == len(jax.tree.leaves(want))
    for g, w in zip(got, jax.tree.leaves(want), strict=True):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and torch.isfinite(g).all()
        # the floor: a self-attention key bias (whisper's ``bk``) shifts
        # every score of a query row alike, so softmax makes its gradient
        # exactly 0; both packages give fp32 noise of ~1e-10 there
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-3))
    if c.family == "encdec":    # the encoder trains through cross-attention
        assert float(grads["encoder"]["pos"].abs().max()) > 0


def test_adamw_steps_match_reference(models):
    rc, c, rp, _ = models
    kw = dict(name="adamw", warmup=2, total_steps=100)
    ro_cfg, po_cfg = ref_opt.OptConfig(**kw), optimizer.OptConfig(**kw)
    ro = ref_opt.opt_init(ro_cfg, rp)
    p, o = bridge.train_state_from_numpy(jax.tree.map(np.asarray, rp),
                                         jax.tree.map(np.asarray, ro),
                                         device="cpu")
    ref = jax.jit(ref_step.make_train_step(rc, ro_cfg, ref_step.StepConfig()))
    port = train_step.make_train_step(c, po_cfg, train_step.StepConfig())
    for i in range(3):
        rb, pb = _batches(c, i)
        rp, ro, rm = ref(rp, ro, rb)
        p, o, m = port(p, o, pb)
        for key in ("loss", "ce", "gnorm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        for name, (atol, rtol) in STEP_TOL.items():
            got, want = (p, rp) if name == "params" else (o[name], ro[name])
            for g, w in zip(tree.leaves(got), jax.tree.leaves(want),
                            strict=True):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=atol, rtol=rtol,
                                           err_msg=f"{name} step {i + 1}")


def test_whisper_train_state_bridge_and_checkpoints(tmp_path):
    """A whisper train state (encoder subtree, cross slots) crosses the
    bridge leaf for leaf in the reference's tree order, and a checkpoint
    written by either package restores in the other bit for bit."""
    rc, c, rp, _ = _whisper()
    ro = ref_opt.opt_init(ref_opt.OptConfig(), rp)
    rstate = jax.tree.map(np.asarray, (rp, ro))
    p, o = bridge.train_state_from_numpy(*rstate, device="cpu")
    assert [k for k, _ in _leaves(p)] == [
        tuple(getattr(k, "key", k) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(rp)[0]]
    for g, w in zip(tree.leaves((p, o)), jax.tree.leaves(rstate),
                    strict=True):
        np.testing.assert_array_equal(g.numpy(), w)
    ckpt.save((p, o), tmp_path / "port", step=2)
    template = jax.tree.map(jnp.zeros_like, rstate)
    got, manifest = ref_ckpt.restore(template, tmp_path / "port")
    assert manifest["step"] == 2
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(rstate),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    ref_ckpt.save(rstate, tmp_path / "ref", step=3)
    zeros = tree.tree_map(torch.zeros_like, (p, o))
    got, manifest = ckpt.restore(zeros, tmp_path / "ref")
    assert manifest["step"] == 3
    for a, b in zip(tree.leaves(got), tree.leaves((p, o)), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
