"""MoE FFN parity: ``repro_torch.models.moe`` against ``repro.models.moe``.

The same numpy tokens and weights (the reference's ``moe_init``, moved
across as numpy) go through both packages on the CPU, fp32 reduced
configs, at 1e-5: ``router_topk`` (weights, experts, aux),
``expert_capacity``, the capacity scatter dispatch ``moe_forward``, the
masked-einsum ``moe_forward_einsum`` (``moe_impl("dense")``) and the
oracle ``moe_forward_dense``, with a capacity factor small enough that
the dispatch drops pairs, and with llama4's shared expert. The weights
are random, so the router's top-k has no exact ties (``torch.topk`` and
``jax.lax.top_k`` may order ties differently).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import moe

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
         "jamba-v0.1-52b"]


def _configs(arch, **over):
    kw = dict(dtype="float32", param_dtype="float32", **over)
    return ref_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _setup(arch, seed=0, b=3, s=7, **over):
    rc, c = _configs(arch, **over)
    rp = ref_moe.moe_init(jax.random.key(seed), rc)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    x = np.random.default_rng(seed).normal(
        size=(b, s, rc.d_model)).astype(np.float32)
    return rc, c, rp, p, x


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    rc, c, rp, _p, _x = _setup(arch)
    gen = torch.Generator().manual_seed(0)
    got = moe.moe_init(gen, c)
    want = jax.tree.map(np.asarray, rp)
    assert got.keys() == want.keys()
    for key in want:
        sub_w = want[key] if isinstance(want[key], dict) else {"": want[key]}
        sub_g = got[key] if isinstance(got[key], dict) else {"": got[key]}
        assert sub_g.keys() == sub_w.keys(), key
        for name, a in sub_w.items():
            assert tuple(sub_g[name].shape) == a.shape, (key, name)
            assert str(sub_g[name].dtype).endswith(str(a.dtype)), (key, name)
    assert got["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_matches_reference(arch):
    rc, c, rp, p, x = _setup(arch, seed=1)
    x2d = x.reshape(-1, rc.d_model)
    ww, we, wa = ref_moe.router_topk(rc, rp, jnp.asarray(x2d))
    gw, ge, ga = moe.router_topk(c, p, torch.from_numpy(x2d))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    _close(gw, ww)
    _close(ga, wa)
    np.testing.assert_allclose(gw.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("n_tokens", [1, 8, 21, 64, 1000])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches_reference(arch, n_tokens):
    rc, c = _configs(arch)
    for cf in (1.25, 0.3, 2.0):
        assert moe.expert_capacity(
            dataclasses.replace(c, capacity_factor=cf), n_tokens) == \
            ref_moe.expert_capacity(
                dataclasses.replace(rc, capacity_factor=cf), n_tokens)
    full = get_config(arch)
    assert moe.expert_capacity(full, n_tokens) == ref_moe.expert_capacity(
        ref_get_config(arch), n_tokens)


FORWARDS = {
    "scatter": (moe.moe_forward, ref_moe.moe_forward),
    "einsum": (moe.moe_forward_einsum, ref_moe.moe_forward_einsum),
    "dense": (moe.moe_forward_dense, ref_moe.moe_forward_dense),
}


@pytest.mark.parametrize("fwd", list(FORWARDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, fwd):
    rc, c, rp, p, x = _setup(arch, seed=2)
    port, ref = FORWARDS[fwd]
    want, waux = ref(rc, rp, jnp.asarray(x))
    got, gaux = port(c, p, torch.from_numpy(x))
    _close(got, want)
    _close(gaux, waux)


@pytest.mark.parametrize("arch", ARCHS)
def test_dropping_dispatch_matches_reference(arch):
    """capacity_factor 0.3 at 64 tokens: capacity below the busiest
    expert's load, so pairs drop; the port drops the same ones (its
    output differs from the no-drop oracle exactly as the reference's
    does)."""
    rc, c, rp, p, x = _setup(arch, seed=3, b=4, s=16, capacity_factor=0.3)
    t = x.shape[0] * x.shape[1]
    cap = moe.expert_capacity(c, t)
    _w, experts, _a = moe.router_topk(c, p, torch.from_numpy(
        x.reshape(t, -1)))
    load = torch.bincount(experts.reshape(-1), minlength=c.n_experts)
    assert int(load.max()) > cap, (load, cap)
    want, _ = ref_moe.moe_forward(rc, rp, jnp.asarray(x))
    got, _ = moe.moe_forward(c, p, torch.from_numpy(x))
    _close(got, want)
    oracle, _ = moe.moe_forward_dense(c, p, torch.from_numpy(x))
    assert not torch.allclose(got, oracle, rtol=1e-3, atol=1e-3)


def test_no_drops_equal_the_oracle():
    """With room for every pair the scatter dispatch is the oracle."""
    _rc, c, _rp, p, x = _setup("granite-moe-3b-a800m", seed=4,
                               capacity_factor=8.0)
    got, aux = moe.moe_forward(c, p, torch.from_numpy(x))
    want, waux = moe.moe_forward_dense(c, p, torch.from_numpy(x))
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(aux, waux, rtol=0, atol=0)


def test_moe_impl_selects_the_einsum_dispatch():
    _rc, c, _rp, p, x = _setup("granite-moe-3b-a800m", seed=5,
                               capacity_factor=0.3)
    xt = torch.from_numpy(x)
    with moe.moe_impl("dense"):
        got, _ = moe.moe_forward(c, p, xt)
    want, _ = moe.moe_forward_einsum(c, p, xt)
    assert torch.equal(got, want)
    scatter, _ = moe.moe_forward(c, p, xt)      # the default again
    assert not torch.allclose(scatter, want, rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="scatter or dense"):
        with moe.moe_impl("ragged"):
            pass


def test_shared_expert_is_added():
    """llama4's shared expert runs on every token beside the routed
    ones: removing it changes the output by exactly its MLP."""
    rc, c, rp, p, x = _setup("llama4-maverick-400b-a17b", seed=6)
    assert c.moe_shared and "shared" in p
    xt = torch.from_numpy(x)
    with_shared, _ = moe.moe_forward(c, p, xt)
    c0 = dataclasses.replace(c, moe_shared=False)
    without, _ = moe.moe_forward(c0, p, xt)
    from repro_torch.models.common import apply_mlp
    extra = apply_mlp(c, p["shared"], xt.reshape(-1, c.d_model))
    torch.testing.assert_close(with_shared - without,
                               extra.reshape(with_shared.shape), **TOL)
    want, _ = ref_moe.moe_forward(rc, rp, jnp.asarray(x))
    _close(with_shared, want)


def test_gradients_match_reference():
    """The scatter dispatch's backward (index_add, gather) against
    jax.grad of the reference's, dropping pairs: 1e-5."""
    rc, c, rp, p, x = _setup("granite-moe-3b-a800m", seed=7, b=2, s=16,
                             capacity_factor=0.5)

    def ref_loss(q, xx):
        y, aux = ref_moe.moe_forward(rc, q, xx)
        return jnp.sum(jnp.sin(y)) + aux

    wg_p, wg_x = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    leaves = {k: v for k, v in p.items() if k != "experts"}
    leaves.update({f"experts.{k}": v for k, v in p["experts"].items()})
    req = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    q = {"router": req["router"],
         "experts": {k[8:]: v for k, v in req.items()
                     if k.startswith("experts.")}}
    y, aux = moe.moe_forward(c, q, xt)
    (torch.sin(y).sum() + aux).backward()
    _close(xt.grad, wg_x)
    _close(req["router"].grad, wg_p["router"])
    for k, v in wg_p["experts"].items():
        _close(req[f"experts.{k}"].grad, v)
