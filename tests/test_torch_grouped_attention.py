"""The grouped attention formulation against the reference's.

``sdpa(..., impl="grouped")`` views the queries as (Kh, G) groups and
contracts each against its K/V head without repeating K/V; the
reference's decode defaults to it. Same numpy inputs through both
packages on the CPU:

  * ``sdpa`` grouped equals the port's repeat at 1e-6 and the
    reference's grouped at 1e-5, with and without a mask and a window,
    at H == Kh and H > Kh; ``sdpa_chunked_q`` and ``attend`` take it;
  * ``lm.decode_step`` (grouped by default, as the reference's) gives
    the reference's logits at 1e-4 for every family, at a shared
    position and at per-row positions, and the repeat formulation's;
  * the serve factories and the model functions take ``impl`` with the
    reference's defaults;
  * ``skip_attention_core`` zeroes the core of ``attend`` as the
    reference's probe does.

The engines' and ``generate``'s streams (grouped on both sides since the
port's dense decode took the reference's default) are held to the
reference's in test_torch_slotted_serve.py, test_torch_generate.py and
test_torch_encdec_vlm.py.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import lm as ref_lm
from repro.serve import cache as ref_cache
from repro.serve import engine as ref_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import attention, blocks, lm
from repro_torch.serve import cache, engine

torch.set_num_threads(1)

#: one architecture of each family
FAMILIES = ["llama3.2-3b", "granite-moe-3b-a800m", "mamba2-1.3b",
            "jamba-v0.1-52b", "whisper-small", "llava-next-34b"]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(h, kh, s=5, t=7, b=2, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, dh)).astype(np.float32),
            rng.normal(size=(b, t, kh, dh)).astype(np.float32),
            rng.normal(size=(b, t, kh, dh)).astype(np.float32))


def _mask(kind, s=5, t=7, b=2):
    if kind is None:
        return None
    if kind == "rows":         # per-row positions, as the slotted decode
        pos = np.array([[t - 1], [t - 3]])
        return (np.arange(t)[None, :] <= pos)[:, None, None, :]
    window = 3 if kind == "window" else None
    return np.asarray(ref_attn.make_causal_mask(s, t, window,
                                                q_offset=t - s))[None, None]


@pytest.mark.parametrize("mask", [None, "causal", "window", "rows"])
@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2)])
def test_sdpa_grouped(h, kh, mask):
    q, k, v = _qkv(h, kh)
    m = _mask(mask)
    tm = None if m is None else _t(m)
    got = attention.sdpa(_t(q), _t(k), _t(v), tm, impl="grouped")
    rep = attention.sdpa(_t(q), _t(k), _t(v), tm, impl="repeat")
    torch.testing.assert_close(got, rep, rtol=1e-6, atol=1e-6)
    want = ref_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         None if m is None else jnp.asarray(m),
                         impl="grouped")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_sdpa_rejects_an_unknown_formulation():
    q, k, v = _qkv(8, 2)
    with pytest.raises(ValueError, match="impl"):
        attention.sdpa(_t(q), _t(k), _t(v), None, impl="flash")


@pytest.mark.parametrize("window", [None, 64])
def test_chunked_q_and_attend_take_the_grouped_formulation(window):
    q, k, v = _qkv(8, 2, s=512, t=512, b=1)
    args = [_t(a) for a in (q, k, v)]
    kw = dict(causal=True, window=window)
    torch.testing.assert_close(
        attention.sdpa_chunked_q(*args, impl="grouped", **kw),
        attention.sdpa_chunked_q(*args, impl="repeat", **kw),
        rtol=1e-6, atol=1e-6)
    c = get_config("llama3.2-3b").reduced(attn_window=window, n_heads=8)
    torch.testing.assert_close(
        attention.attend(c, *args, causal=True, impl="grouped"),
        attention.attend(c, *args, causal=True, impl="repeat"),
        rtol=1e-6, atol=1e-6)


def test_skip_attention_core_zeroes_attend():
    q, k, v = _qkv(8, 2)
    c = get_config("llama3.2-3b").reduced(n_heads=8)
    with attention.skip_attention_core():
        out = attention.attend(c, _t(q), _t(k), _t(v), causal=True)
    rc = ref_get_config("llama3.2-3b").reduced(n_heads=8)
    with ref_attn.skip_attention_core():
        want = ref_attn.attend(rc, jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, impl="repeat")
    assert out.shape == q.shape and not out.any()
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert attention.attend(c, _t(q), _t(k), _t(v), causal=True).any()


def _defaults(fn):
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if k == "impl"}


@pytest.mark.parametrize("name", [
    "models.attention.sdpa", "models.attention.sdpa_chunked_q",
    "models.attention.attend", "models.attention.self_attention",
    "models.attention.cross_attention", "models.attention.prefill_attention",
    "models.attention.decode_attention", "models.blocks.stack_forward",
    "models.blocks.stack_prefill", "models.blocks.stack_decode",
    "models.lm.forward", "models.lm.prefill", "models.lm.decode_step",
    "serve.engine.make_prefill_fn", "serve.engine.make_decode_fn"])
def test_impl_defaults_are_the_references(name):
    mod, fn = name.rsplit(".", 1)
    ports = {"models.attention": attention, "models.blocks": blocks,
             "models.lm": lm, "serve.engine": engine}
    refs = {"models.attention": ref_attn, "models.blocks": ref_blocks,
            "models.lm": ref_lm, "serve.engine": ref_engine}
    got = _defaults(getattr(ports[mod], fn))
    want = _defaults(getattr(refs[mod], fn))
    assert "impl" in got and "impl" in want
    if want["impl"] is not inspect.Parameter.empty:
        assert got == want
    else:          # the reference's sdpa_chunked_q and attend require it
        assert got == {"impl": "repeat"}


def _configs(arch):
    kw = {"dtype": "float32", "param_dtype": "float32"}
    if arch.startswith("jamba"):
        kw["max_position"] = 1024
    return ref_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _side(c, b, rng):
    if c.family == "vlm":
        return {"patch_embeds": rng.normal(
            size=(b, c.n_patches, c.d_model)).astype(np.float32)}
    if c.family == "encdec":
        return {"enc_frames": rng.normal(
            size=(b, c.enc_seq, c.d_model)).astype(np.float32)}
    return {}


@pytest.fixture(scope="module", params=FAMILIES)
def models(request):
    rc, c = _configs(request.param)
    rp = jax.jit(ref_lm.init, static_argnums=1)(jax.random.key(0), rc)
    return rc, c, rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_matches_reference(models, per_row):
    """Prefill 8 tokens, then two grouped decode steps into dense caches
    grown to 16 more rows: logits at 1e-4 of the reference's, and equal
    to the port's repeat formulation at 1e-5."""
    rc, c, rp, p = models
    rng = np.random.default_rng(1)
    b, s = 2, 8
    toks = rng.integers(0, c.vocab, (b, s)).astype(np.int32)
    side = _side(c, b, rng)
    _, rcaches, renc = ref_lm.prefill(
        rc, rp, jnp.asarray(toks), **{k: jnp.asarray(v)
                                      for k, v in side.items()})
    _, caches, enc = lm.prefill(c, p, _t(toks).long(),
                                **{k: _t(v) for k, v in side.items()})
    n0 = s + (c.n_patches if c.family == "vlm" else 0)
    rcaches = ref_cache.grow_caches(rcaches, n0 + 16)
    caches = cache.grow_caches(caches, n0 + 16)
    twin = {slot: {n: t.clone() for n, t in tree.items()}   # for repeat
            for slot, tree in caches.items()}
    for step in range(2):
        tok = rng.integers(0, c.vocab, (b, 1)).astype(np.int32)
        pos = np.array([n0 + step, n0 + step - 1]) if per_row else n0 + step
        want, rcaches = ref_lm.decode_step(rc, rp, jnp.asarray(tok), rcaches,
                                           jnp.asarray(pos, jnp.int32),
                                           enc_kv=renc)
        tpos = _t(pos) if per_row else pos
        got, caches = lm.decode_step(c, p, _t(tok).long(), caches, tpos,
                                     enc_kv=enc)
        rep, twin = lm.decode_step(c, p, _t(tok).long(), twin, tpos,
                                   enc_kv=enc, impl="repeat")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
        torch.testing.assert_close(got, rep, rtol=1e-5, atol=1e-5)
