"""Mamba2 / SSD parity: ``repro_torch.models.ssm`` against
``repro.models.ssm``.

The same numpy inputs and weights (the reference's ``mamba_init``, moved
across as numpy) go through both packages on the CPU in fp32:

  * ``ssd_chunked`` against the reference's at chunk 8, 16, 32 and 64
    (1e-5), and against the oracle ``kernels.ref.ssd_chunk_ref`` chunk by
    chunk (which itself matches the reference's oracle);
  * ``ssd_decode_step``, ``_causal_conv``, ``_conv_step``,
    ``_gated_norm`` and ``_segsum`` (1e-5);
  * ``mamba_forward`` with its returned (conv tail, state), and
    ``mamba_decode`` continuing from it (1e-5), on a reduced mamba2 and
    on a reduced jamba's mamba slot;
  * the chunk rule at a prime length (chunk 1: ``s`` sequential steps);
  * gradients of ``mamba_forward`` against ``jax.grad`` at 1e-4 of each
    leaf's largest gradient (the fp32 sums over the sequence cancel: in
    float64 both packages are ~6e-5 off the true value at worst, on
    leaves whose largest element is 3.5 to 185);
  * in bf16 the prefill's final state stays fp32 and ``mamba_decode``
    keeps the dtype of the state it is given.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ref as ref_kernels
from repro.models import ssm as ref_ssm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ref as kref
from repro_torch.models import ssm

torch.set_num_threads(1)

OP_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=OP_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _inputs(b=2, s=64, nh=4, p=8, n=16, seed=0):
    rng = np.random.default_rng(seed)
    xdt = (rng.normal(size=(b, s, nh, p)) * 0.5).astype(np.float32)
    dA = (-np.abs(rng.normal(size=(b, s, nh))) * 0.3).astype(np.float32)
    B = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    h0 = (rng.normal(size=(b, nh, p, n)) * 0.5).astype(np.float32)
    return xdt, dA, B, C, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_ssd_chunked_matches_reference(chunk, with_h0):
    xdt, dA, B, C, h0 = _inputs()
    h0 = h0 if with_h0 else None
    wy, wh = ref_ssm.ssd_chunked(*map(jnp.asarray, (xdt, dA, B, C)), chunk,
                                 h0=None if h0 is None else jnp.asarray(h0))
    gy, gh = ssm.ssd_chunked(*map(_t, (xdt, dA, B, C)), chunk,
                             h0=None if h0 is None else _t(h0))
    assert gh.dtype == torch.float32
    _close(gy, wy)
    _close(gh, wh)


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_the_chunk_oracle(chunk):
    """Chunk by chunk, the oracle carrying its own state, per batch
    row; the port's oracle also equals the reference's."""
    xdt, dA, B, C, h0 = _inputs(seed=1)
    gy, gh = ssm.ssd_chunked(*map(_t, (xdt, dA, B, C)), chunk, h0=_t(h0))
    for bi in range(xdt.shape[0]):
        h = _t(h0[bi])
        for j in range(xdt.shape[1] // chunk):
            sl = slice(j * chunk, (j + 1) * chunk)
            args = [_t(a[bi, sl]) for a in (xdt, dA, B, C)]
            y, h_new = kref.ssd_chunk_ref(*args, h)
            wy, wh = ref_kernels.ssd_chunk_ref(
                *[jnp.asarray(a[bi, sl]) for a in (xdt, dA, B, C)],
                jnp.asarray(h.numpy()))
            _close(y, wy)
            _close(h_new, wh)
            _close(gy[bi, sl], y.numpy())
            h = h_new
        _close(gh[bi], h.numpy())


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(2)
    b, nh, p, n = 3, 4, 8, 16
    h = rng.normal(size=(b, nh, p, n)).astype(np.float32)
    x = rng.normal(size=(b, nh, p)).astype(np.float32)
    dt = np.abs(rng.normal(size=(b, nh))).astype(np.float32)
    A = -np.abs(rng.normal(size=(nh,))).astype(np.float32)
    B = rng.normal(size=(b, n)).astype(np.float32)
    C = rng.normal(size=(b, n)).astype(np.float32)
    wy, wh = ref_ssm.ssd_decode_step(*map(jnp.asarray, (h, x, dt, A, B, C)))
    gy, gh = ssm.ssd_decode_step(*map(_t, (h, x, dt, A, B, C)))
    _close(gy, wy)
    _close(gh, wh)


def test_conv_norm_and_segsum_match_reference():
    rng = np.random.default_rng(3)
    xbc = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    _close(ssm._causal_conv(_t(xbc), _t(w), _t(b)),
           ref_ssm._causal_conv(*map(jnp.asarray, (xbc, w, b))))
    state = rng.normal(size=(2, 3, 12)).astype(np.float32)
    new = rng.normal(size=(2, 1, 12)).astype(np.float32)
    wo, ws = ref_ssm._conv_step(*map(jnp.asarray, (state, new, w, b)))
    go, gs = ssm._conv_step(*map(_t, (state, new, w, b)))
    _close(go, wo)
    _close(gs, ws)
    y, z = (rng.normal(size=(2, 5, 12)).astype(np.float32) for _ in range(2))
    _close(ssm._gated_norm(_t(y), _t(z), _t(b)),
           ref_ssm._gated_norm(*map(jnp.asarray, (y, z, b))))
    a = rng.normal(size=(2, 3, 7)).astype(np.float32)
    np.testing.assert_allclose(ssm._segsum(_t(a)).numpy(),
                               np.asarray(ref_ssm._segsum(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-6)


def _mamba(arch, dtype="float32", seed=0):
    kw = dict(dtype=dtype, param_dtype=dtype)
    rc = ref_get_config(arch).reduced(**kw)
    c = get_config(arch).reduced(**kw)
    rp = ref_ssm.mamba_init(jax.random.key(seed), rc)
    # non-trivial dt_bias and conv bias (both initialise to zeros)
    rng = np.random.default_rng(seed)
    rp = dict(rp, dt_bias=jnp.asarray(rng.normal(size=rp["dt_bias"].shape),
                                      jnp.float32),
              conv_b=jnp.asarray(rng.normal(size=rp["conv_b"].shape) * 0.1,
                                 rp["conv_b"].dtype))
    p = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rc, c, rp, p


def test_init_matches_reference_tree():
    rc, c, rp, _p = _mamba("mamba2-1.3b")
    got = ssm.mamba_init(torch.Generator().manual_seed(0), c, lead=(3,))
    assert got.keys() == rp.keys()
    for k, a in rp.items():
        assert tuple(got[k].shape) == (3,) + a.shape, k
        assert str(got[k].dtype).endswith(str(a.dtype)), k
    _close(got["A_log"][1], rp["A_log"])
    assert (got["D"] == 1).all() and (got["dt_bias"] == 0).all()


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_mamba_forward_and_decode_match_reference(arch):
    """Prefill a 64-token prompt (two 32-token chunks) with its state,
    then four decode steps from that state."""
    rc, c, rp, p = _mamba(arch, seed=4)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 64, rc.d_model)).astype(np.float32)
    wout, (wconv, wh) = ref_ssm.mamba_forward(rc, rp, jnp.asarray(x),
                                              return_state=True)
    gout, (gconv, gh) = ssm.mamba_forward(c, p, _t(x), return_state=True)
    _close(gout, wout)
    _close(gconv, wconv)
    _close(gh, wh)
    conv, h = gconv.clone(), gh.clone()
    for i in range(4):
        xt = rng.normal(size=(2, 1, rc.d_model)).astype(np.float32)
        wout, wconv, wh = ref_ssm.mamba_decode(rc, rp, jnp.asarray(xt),
                                               wconv, wh)
        gout, conv, h = ssm.mamba_decode(c, p, _t(xt), conv, h)
        _close(gout, wout)
        _close(conv, wconv)
        _close(h, wh)


def test_decode_continues_the_prefill():
    """mamba_decode from a prefill's state gives what the prefill of the
    longer sequence gives at its last position."""
    _rc, c, _rp, p = _mamba("mamba2-1.3b", seed=5)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 33, c.d_model)).astype(np.float32))
    full = ssm.mamba_forward(c, p, x)
    _out, (conv, h) = ssm.mamba_forward(c, p, x[:, :32], return_state=True)
    last, _conv, _h = ssm.mamba_decode(c, p, x[:, 32:], conv, h)
    torch.testing.assert_close(last, full[:, 32:], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s", [37, 31, 48])
def test_chunk_rule_matches_reference(s):
    """The largest divisor of s not above ssm_chunk (32 reduced): 37 is
    prime -> chunk 1 (37 sequential steps), 31 -> 31, 48 -> 24."""
    rc, c, rp, p = _mamba("mamba2-1.3b", seed=6)
    assert ssm.ssd_chunk_size(c, s) == {37: 1, 31: 31, 48: 24}[s]
    x = np.random.default_rng(s).normal(
        size=(1, s, rc.d_model)).astype(np.float32)
    wout, (_wc, wh) = ref_ssm.mamba_forward(rc, rp, jnp.asarray(x),
                                            return_state=True)
    gout, (_gc, gh) = ssm.mamba_forward(c, p, _t(x), return_state=True)
    _close(gout, wout)
    _close(gh, wh)
    full = get_config("mamba2-1.3b")
    assert ssm.ssd_chunk_size(full, 257) == 1
    assert ssm.ssd_chunk_size(full, 512) == 256


def test_gradients_match_jax_grad():
    rc, c, rp, p = _mamba("mamba2-1.3b", seed=7)
    x = np.random.default_rng(7).normal(
        size=(2, 64, rc.d_model)).astype(np.float32)

    def ref_loss(q, xx):
        return jnp.sum(jnp.sin(ref_ssm.mamba_forward(rc, q, xx)))

    wg_p, wg_x = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    req = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = _t(x).requires_grad_(True)
    torch.sin(ssm.mamba_forward(c, req, xt)).sum().backward()
    for got, want in [(xt.grad, wg_x)] + [(req[k].grad, v)
                                          for k, v in wg_p.items()]:
        assert torch.isfinite(got).all()
        want = np.asarray(want)
        _close(got, want, dict(rtol=1e-4, atol=1e-4 * np.abs(want).max()))


def test_bf16_state_stays_fp32_and_decode_keeps_its_dtype():
    _rc, c, _rp, p = _mamba("mamba2-1.3b", dtype="bfloat16", seed=8)
    x = torch.randn((1, 16, c.d_model),
                    generator=torch.Generator().manual_seed(8)).bfloat16()
    out, (conv, h) = ssm.mamba_forward(c, p, x, return_state=True)
    assert out.dtype == conv.dtype == torch.bfloat16
    assert h.dtype == torch.float32
    _o, conv2, h2 = ssm.mamba_decode(c, p, x[:, :1], conv, h)
    assert h2.dtype == torch.float32 and conv2.dtype == torch.bfloat16
    _o, _c, h3 = ssm.mamba_decode(c, p, x[:, :1], conv, h.bfloat16())
    assert h3.dtype == torch.bfloat16
