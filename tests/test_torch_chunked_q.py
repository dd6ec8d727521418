"""The q-chunked attention path (``attention.sdpa_chunked_q``) against
the reference's, on the CPU.

Both packages take it when the score tensor holds more than
``CHUNK_THRESHOLD`` elements and the queries are whole chunks of 256
(``attend``); the tests lower the threshold in both packages so that
small shapes take it:

  * causal, causal with a window (K/V sliced to what a chunk sees) and
    bidirectional: outputs and the gradients of q, k and v at 1e-5, and
    equal to the port's full ``sdpa`` under the same mask;
  * a reduced fp32 llama3.2-3b forward (with and without a window) that
    goes through the chunked path: logits and every parameter's
    gradient against the reference's at 1e-4, and the call counter
    moves;
  * 300 query rows are not whole chunks: both packages fall back to
    full ``sdpa``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import lm as ref_lm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.models import attention, lm

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MODES = {"causal": (True, None), "window": (True, 96),
         "bidirectional": (False, None)}


def _qkv(s, t, seed, b=2, h=4, kh=2, dh=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, dh), (b, t, kh, dh), (b, t, kh, dh))]


@pytest.fixture
def low_threshold(monkeypatch):
    monkeypatch.setattr(ref_attn, "CHUNK_THRESHOLD", 0)
    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 0)


@pytest.mark.parametrize("mode", MODES)
def test_chunked_matches_reference(mode):
    causal, window = MODES[mode]
    arrays = _qkv(512, 512, seed=1)
    cot = np.random.default_rng(2).standard_normal(
        arrays[0].shape).astype(np.float32)

    def ref_loss(q, k, v):
        out = ref_attn.sdpa_chunked_q(q, k, v, causal=causal, window=window,
                                      impl="repeat", q_chunk=256)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True))(
        *[jnp.asarray(a) for a in arrays])
    q, k, v = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    calls = attention.sdpa_chunked_q.calls
    out = attention.sdpa_chunked_q(q, k, v, causal=causal, window=window)
    assert attention.sdpa_chunked_q.calls == calls + 1
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                (q, k, v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    for g, w in zip(grads, jgrads, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    mask = attention.make_causal_mask(512, 512, window)[None, None] \
        if causal else None
    with torch.no_grad():
        full = attention.sdpa(q, k, v, mask)
    torch.testing.assert_close(out.detach(), full, **TOL)


@pytest.mark.parametrize("window", [None, 96])
def test_model_takes_the_chunked_path(low_threshold, window):
    over = dict(dtype="float32", param_dtype="float32", attn_window=window)
    rc = ref_get_config("llama3.2-3b").reduced(**over)
    c = get_config("llama3.2-3b").reduced(**over)
    rp = jax.jit(ref_lm.init, static_argnums=1)(jax.random.key(0), rc)
    p = bridge.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    tok = np.random.default_rng(3).integers(0, c.vocab, (1, 512)).astype(
        np.int32)

    def ref_loss(params):
        logits, _ = ref_lm.forward(rc, params, jnp.asarray(tok))
        return jnp.mean(logits ** 2), logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(ref_loss,
                                                   has_aux=True))(rp)
    leaves = [t.requires_grad_(True) for t in tree.leaves(p)]
    calls = attention.sdpa_chunked_q.calls
    logits, _ = lm.forward(c, tree.unflatten(p, leaves),
                           torch.from_numpy(tok))
    assert attention.sdpa_chunked_q.calls == calls + c.n_layers
    grads = torch.autograd.grad(logits.square().mean(), leaves)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(grads, jax.tree.leaves(jgrads), strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-6))


def test_partial_chunks_fall_back_to_full_sdpa(low_threshold):
    c = get_config("llama3.2-3b").reduced()
    rc = ref_get_config("llama3.2-3b").reduced()
    arrays = _qkv(300, 300, seed=4)
    calls = attention.sdpa_chunked_q.calls
    got = attention.attend(c, *[torch.from_numpy(a) for a in arrays],
                           causal=True)
    assert attention.sdpa_chunked_q.calls == calls
    want = ref_attn.attend(rc, *[jnp.asarray(a) for a in arrays],
                           causal=True, impl="repeat")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="whole chunks"):
        attention.sdpa_chunked_q(*[torch.from_numpy(a) for a in arrays],
                                 causal=True, window=None)
