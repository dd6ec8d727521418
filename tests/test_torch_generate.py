"""Fixed-batch generation (``ServeEngine.generate``, ``BatchedServer``)
against the reference's, on the CPU.

Reduced fp32 configs, the reference's weights bridged, the same seeded
prompts and side inputs:

  * dense (llama3.2-3b), ssm (mamba2-1.3b), moe (granite-moe-3b-a800m)
    and encdec (whisper-small): the port's greedy tokens equal the
    reference's ``BatchedServer.generate``;
  * vlm (llava-next-34b): the port decodes from the prefill cache's
    length, patches plus text. Its tokens equal the reference's
    ``lm.forward`` greedy stream and the reference's ``lm.prefill`` +
    ``lm.decode_step`` at ``n_patches + S``. The reference's own
    ``generate`` starts at the text length ``S`` and departs from both
    (ROADMAP Queue 3 keeps the caveat; this test keeps it in view);
  * ``python -m repro_torch.launch.serve --mode batch --device cpu``
    serves a dense, an encdec and a vlm model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro.serve.cache import grow_caches as ref_grow
from repro_torch import bridge
from repro_torch.launch import serve as serve_cli
from repro_torch.serve.engine import BatchedServer, GenerationResult
from test_torch_encdec_vlm import configs, side_inputs, tokens
from test_torch_families import ref_init

torch.set_num_threads(1)

B, S, STEPS, BUDGET = 2, 24, 6, 8


def _models(arch):
    rc, c = configs(arch)
    rp = ref_init(rc)
    p = bridge.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    tok = tokens(c, B, S, seed=11)
    rkw, kw = ({}, {}) if c.family not in ("encdec", "vlm") \
        else side_inputs(c, B, seed=12)
    return rc, c, rp, p, tok, rkw, kw


def _port(c, p, tok, kw) -> GenerationResult:
    res = BatchedServer(c, p, max_len=BUDGET, device="cpu").generate(
        torch.from_numpy(tok), STEPS, kw)
    assert res.tokens.shape == (B, STEPS) and res.steps == STEPS
    assert res.prefill_s > 0 and res.decode_tokens_per_s > 0
    return res


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-1.3b",
                                  "granite-moe-3b-a800m", "whisper-small"])
def test_generate_equals_reference(arch):
    rc, c, rp, p, tok, rkw, kw = _models(arch)
    want = ref_engine.BatchedServer(rc, rp, max_len=BUDGET).generate(
        jnp.asarray(tok), STEPS, rkw)
    got = _port(c, p, tok, kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_vlm_generate_decodes_after_the_patches():
    rc, c, rp, p, tok, rkw, kw = _models("llava-next-34b")
    got = _port(c, p, tok, kw).tokens.numpy()
    # the reference's forward, greedy, one token at a time
    fwd = jax.jit(ref_lm.forward, static_argnums=0)
    seq = jnp.asarray(tok)
    stream = []
    for _ in range(STEPS):
        logits, _ = fwd(rc, rp, seq, **rkw)
        nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        stream.append(np.asarray(nxt))
        seq = jnp.concatenate([seq, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(got, np.stack(stream, 1))
    # the reference's prefill, then decode_step at n_patches + S
    n = c.n_patches + S
    logits, caches, _ = jax.jit(ref_lm.prefill, static_argnums=0)(
        rc, rp, jnp.asarray(tok), **rkw)
    caches = ref_grow(caches, n + BUDGET)
    decode = jax.jit(ref_lm.decode_step, static_argnums=0)
    ops = [jnp.argmax(logits[:, -1], -1).astype(jnp.int32)]
    for i in range(STEPS - 1):
        logits, caches = decode(rc, rp, ops[-1][:, None], caches,
                                jnp.int32(n + i))
        ops.append(jnp.argmax(logits[:, -1], -1).astype(jnp.int32))
    np.testing.assert_array_equal(got, np.stack([np.asarray(o) for o in ops],
                                                1))
    # the reference's generate decodes at S, over a live text row: its
    # stream departs after the first token. Its grow_caches needs a budget
    # of at least n_patches to run at all
    ref_gen = ref_engine.BatchedServer(rc, rp, max_len=c.n_patches + BUDGET)
    ref = np.asarray(ref_gen.generate(jnp.asarray(tok), STEPS, rkw).tokens)
    np.testing.assert_array_equal(ref[:, 0], got[:, 0])
    assert (ref[:, 1:] != got[:, 1:]).any()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-small",
                                  "llava-next-34b"])
def test_serve_cli_batch_mode(arch, capsys):
    res = serve_cli.main(["--arch", arch, "--mode", "batch", "--device",
                          "cpu", "--batch", "2", "--prompt-len", "16",
                          "--gen", "4"])
    assert res.tokens.shape == (2, 4)
    assert f"arch={arch}-reduced device=cpu batch=2" in capsys.readouterr().out
