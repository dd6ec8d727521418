"""Model-stack parity: ``repro_torch.models`` against ``repro.models``.

The same numpy inputs and weights go through the JAX function and its
PyTorch port on the CPU (fp32 reduced configs). Single ops must agree to
1e-5; logits after a whole stack to 1e-4 (the error grows with depth).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import attention, common, lm

torch.set_num_threads(1)

#: the dense architectures: llama3.2-3b (the serve path), gpt-800m (the
#: paper's), and qwen2-0.5b (QKV bias, tied embeddings), granite-8b
#: (untied, rope_theta 1e7) and command-r-35b (LayerNorm with SwiGLU)
ARCHS = ["llama3.2-3b", "gpt-800m", "qwen2-0.5b", "granite-8b",
         "command-r-35b"]
OP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(arch, **over):
    kw = dict(dtype="float32", param_dtype="float32", **over)
    return ref_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=OP_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for ref_c, c in (_configs(arch), (ref_get_config(arch), get_config(arch))):
        assert dataclasses.asdict(ref_c) == dataclasses.asdict(c)
        assert ref_c.padded_vocab == c.padded_vocab


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_norm(arch):
    ref_c, c = _configs(arch)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, ref_c.d_model)).astype(np.float32)
    p = {"scale": rng.normal(size=ref_c.d_model).astype(np.float32),
         "bias": rng.normal(size=ref_c.d_model).astype(np.float32)}
    if ref_c.norm == "rmsnorm":
        del p["bias"]
    want = ref_common.apply_norm(ref_c, jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x))
    _close(common.apply_norm(c, jax.tree.map(_t, p), _t(x)), want)


@pytest.mark.parametrize("offset", [0, 37])
def test_apply_rope(offset):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = (np.arange(6)[None, :] + offset).astype(np.int32)
    want = ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    _close(common.apply_rope(_t(x), _t(pos), 500_000.0), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_mlp(arch):
    ref_c, c = _configs(arch)
    rng = np.random.default_rng(2)
    p = jax.tree.map(np.asarray, ref_common.mlp_init(jax.random.key(3), ref_c,
                                                     ref_c.d_ff))
    if "bi" in p:    # make the zero-initialised biases count
        p["bi"] = rng.normal(size=p["bi"].shape).astype(np.float32)
        p["bo"] = rng.normal(size=p["bo"].shape).astype(np.float32)
    x = rng.normal(size=(2, 5, ref_c.d_model)).astype(np.float32)
    want = ref_common.apply_mlp(ref_c, jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x))
    _close(common.apply_mlp(c, jax.tree.map(_t, p), _t(x)), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_and_unembed(arch):
    # vocab 500 pads to 512: the pad mask must match too
    ref_c, c = _configs(arch, vocab=500)
    rng = np.random.default_rng(4)
    p = jax.tree.map(np.asarray,
                     ref_common.embedding_init(jax.random.key(5), ref_c))
    tok = rng.integers(0, ref_c.vocab, size=(2, 7)).astype(np.int32)
    want = ref_common.embed_tokens(ref_c, jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(tok))
    _close(common.embed_tokens(c, jax.tree.map(_t, p), _t(tok)), want)
    x = rng.normal(size=(2, 3, ref_c.d_model)).astype(np.float32)
    want = ref_common.unembed(ref_c, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x))
    got = common.unembed(c, jax.tree.map(_t, p), _t(x))
    _close(got, want)
    assert (got[..., ref_c.vocab:] < -1e38).all()


@pytest.mark.parametrize("impl", ["repeat", "grouped"])
@pytest.mark.parametrize("window", [None, 5])
def test_sdpa(impl, window):
    """The port's single sdpa matches both of the reference's GQA
    formulations."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    jmask = ref_attn.make_causal_mask(9, 9, window)[None, None]
    want = ref_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jmask, impl=impl)
    mask = attention.make_causal_mask(9, 9, window)[None, None]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    _close(attention.sdpa(_t(q), _t(k), _t(v), mask), want)


def _attn_params(ref_c, seed=7):
    return jax.tree.map(np.asarray,
                        ref_attn.attn_init(jax.random.key(seed), ref_c))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_attention_dense(arch):
    ref_c, c = _configs(arch)
    p = _attn_params(ref_c)
    x = np.random.default_rng(8).normal(
        size=(2, 12, ref_c.d_model)).astype(np.float32)
    want, (wk, wv) = ref_attn.prefill_attention(
        ref_c, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got, (k, v) = attention.prefill_attention(c, jax.tree.map(_t, p), _t(x))
    _close(got, want)
    _close(k, wk)
    _close(v, wv)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_attention_paged_prefix(arch):
    ref_c, c = _configs(arch)
    p = _attn_params(ref_c)
    rng = np.random.default_rng(9)
    bs, npre, sq, b = 8, 2, 8, 2
    kh, dh = ref_c.n_kv_heads, ref_c.d_head
    k_pool = rng.normal(size=(6, bs, kh, dh)).astype(np.float32)
    v_pool = rng.normal(size=(6, bs, kh, dh)).astype(np.float32)
    tables = np.array([[3, 1], [5, 2]], np.int32)
    x = rng.normal(size=(b, sq, ref_c.d_model)).astype(np.float32)
    pos = (np.arange(sq)[None, :] + npre * bs).astype(np.int32)
    want, _ = ref_attn.prefill_attention(
        ref_c, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        positions=jnp.asarray(pos),
        paged_prefix=(jnp.asarray(k_pool), jnp.asarray(v_pool), None, None,
                      jnp.asarray(tables), "xla", False))
    got, _ = attention.prefill_attention(
        c, jax.tree.map(_t, p), _t(x), positions=_t(pos),
        paged_prefix=(_t(k_pool), _t(v_pool), None, None, _t(tables)))
    _close(got, want)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    ref_c, c = _configs(request.param)
    ref_p = ref_lm.init(jax.random.key(0), ref_c)
    p = params_from_numpy(jax.tree.map(np.asarray, ref_p), "cpu")
    return ref_c, c, ref_p, p


def test_forward_logits(models):
    ref_c, c, ref_p, p = models
    tok = np.random.default_rng(10).integers(
        0, ref_c.vocab, size=(2, 11)).astype(np.int32)
    want, _ = ref_lm.forward(ref_c, ref_p, jnp.asarray(tok))
    got, _ = lm.forward(c, p, _t(tok))
    _close(got, want, LOGIT_TOL)


def test_prefill_then_paged_decode_logits(models):
    """lm.prefill (right-padded batch, per-row last_pos) and four paged
    lm.decode_step calls, against the reference step by step."""
    ref_c, c, ref_p, p = models
    rng = np.random.default_rng(11)
    b, s, bs, max_blocks = 2, 16, 8, 4
    lens = np.array([13, 16], np.int32)
    tok = rng.integers(0, ref_c.vocab, size=(b, s)).astype(np.int32)
    want, jcaches, _ = ref_lm.prefill(ref_c, ref_p, jnp.asarray(tok),
                                      last_pos=jnp.asarray(lens - 1))
    got, caches, _ = lm.prefill(c, p, _t(tok), last_pos=_t(lens - 1))
    _close(got, want, LOGIT_TOL)
    # scatter both prompts into a shared pool through shuffled tables
    tables = np.array([[4, 2, 7, 0], [1, 6, 3, 5]], np.int32)
    n_blocks = 8
    pools = {}
    for name in ("k", "v"):
        rows = np.asarray(jcaches["slot0"][name])      # (L, B, S, Kh, Dh)
        _close(caches["slot0"][name], rows, LOGIT_TOL)
        pool = np.zeros((rows.shape[0], n_blocks, bs) + rows.shape[3:],
                        np.float32)
        for i in range(b):
            for j in range(s // bs):
                pool[:, tables[i, j]] = rows[:, i, j * bs:(j + 1) * bs]
        pools[name] = pool
    jpool = {"slot0": {n: jnp.asarray(v) for n, v in pools.items()}}
    tpool = {"slot0": {n: _t(v.copy()) for n, v in pools.items()}}
    pos = lens.copy()
    nxt = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)
    for _ in range(4):
        want, jpool = ref_lm.decode_step(
            ref_c, ref_p, jnp.asarray(nxt[:, None]), jpool, jnp.asarray(pos),
            block_tables=jnp.asarray(tables), n_kv_blocks=3)
        got, tpool = lm.decode_step(c, p, _t(nxt[:, None]), tpool, _t(pos),
                                    block_tables=_t(tables), n_kv_blocks=3)
        _close(got, want, LOGIT_TOL)
        nxt = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)
        pos = pos + 1
    for name in ("k", "v"):
        _close(tpool["slot0"][name], jpool["slot0"][name], LOGIT_TOL)
