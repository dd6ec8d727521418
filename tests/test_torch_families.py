"""The moe, ssm and hybrid decoder families: the port's model stack
against the reference's, on the CPU.

Reduced fp32 configs of granite-moe-3b-a800m (MoE on every layer),
mamba2-1.3b (attention-free), jamba-v0.1-52b (mamba + one attention
layer a period, MoE on every second layer, learned positions) and
llama4-maverick-400b-a17b (a period of two: dense then MoE with a shared
expert), the same weights (the reference's ``lm.init``, bridged) and the
same numpy tokens through both packages:

  * the port's own ``lm.init`` builds the reference's tree: keys
    ``slot{i}`` of one period, every leaf stacked over the periods, same
    shapes and dtypes;
  * ``forward`` logits and aux at 1e-4;
  * ``prefill`` (exact-length rows for stacks with mamba layers, padded
    rows otherwise) and four paged ``decode_step`` calls, caches
    included, at 1e-4.

Jamba's learned-position table is cut to 1024 rows here (``max_position``;
the reduced config keeps the full model's 2**20), in both packages.
The gradients, the train steps and the launchers are in
test_torch_families_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import blocks as ref_blocks
from repro.models import lm as ref_lm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import blocks, lm

torch.set_num_threads(1)

ARCHS = ["granite-moe-3b-a800m", "mamba2-1.3b", "jamba-v0.1-52b",
         "llama4-maverick-400b-a17b"]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(arch, **over):
    kw = {"dtype": "float32", "param_dtype": "float32", **over}
    if arch.startswith("jamba"):
        kw.setdefault("max_position", 1024)
    return ref_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _leaves(t, prefix=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, t


def ref_init(rc, seed=0):
    # jitted: the eager init dispatches one op per draw
    return jax.jit(ref_lm.init, static_argnums=1)(jax.random.key(seed), rc)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    rc, c = configs(request.param)
    rp = ref_init(rc)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rc, c, rp, p


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_pattern_match_reference(arch):
    for full in (False, True):
        rc, c = (ref_get_config(arch), get_config(arch)) if full \
            else configs(arch)
        assert blocks.period_of(c) == ref_blocks.period_of(rc)
        assert blocks.slot_kinds(c) == ref_blocks.slot_kinds(rc)
        assert c.param_count() == rc.param_count()
        assert c.active_param_count() == rc.active_param_count()
        assert (c.d_inner, c.ssm_nheads, c.group_size) == \
            (rc.d_inner, rc.ssm_nheads, rc.group_size)
        for i in range(c.n_layers):
            assert c.is_moe_layer(i) == rc.is_moe_layer(i)
            assert c.is_attn_layer(i) == rc.is_attn_layer(i)
    assert blocks.attn_layers(get_config(arch)) == {
        "granite-moe-3b-a800m": 32, "mamba2-1.3b": 0, "jamba-v0.1-52b": 4,
        "llama4-maverick-400b-a17b": 48}[arch]


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
    assert set(want[k].shape[0] for k in want if k[0] == "layers") == \
        {c.n_layers // blocks.period_of(c)}


def test_forward_logits_and_aux(models):
    rc, c, rp, p = models
    tok = np.random.default_rng(1).integers(
        0, rc.vocab, size=(2, 32)).astype(np.int32)
    want, waux = jax.jit(ref_lm.forward, static_argnums=0)(
        rc, rp, jnp.asarray(tok))
    got, aux = lm.forward(c, p, torch.from_numpy(tok))
    _close(got, want)
    _close(aux, waux)
    assert (float(aux) > 0) == bool(c.n_experts)


def test_prefill_then_paged_decode(models):
    """lm.prefill and four paged decode steps against the reference's,
    step by step: attention rows scattered into a shared pool through
    shuffled tables, mamba state rows carried per row."""
    rc, c, rp, p = models
    rng = np.random.default_rng(2)
    b, s, bs = 2, 16, 8
    recurrent = c.family in ("ssm", "hybrid")
    lens = np.array([16, 16] if recurrent else [13, 16], np.int32)
    tok = rng.integers(0, rc.vocab, size=(b, s)).astype(np.int32)
    want, jrows, _ = jax.jit(ref_lm.prefill, static_argnums=0)(
        rc, rp, jnp.asarray(tok), last_pos=jnp.asarray(lens - 1))
    got, rows, _ = lm.prefill(c, p, torch.from_numpy(tok),
                           last_pos=torch.from_numpy(lens - 1))
    _close(got, want)
    tables = np.array([[4, 2, 7, 0], [1, 6, 3, 5]], np.int32)
    n_blocks = 8
    pools = {}
    for slot, leaves in jrows.items():
        pools[slot] = {}
        for name, rows_j in leaves.items():
            rows_j = np.asarray(rows_j)
            _close(rows[slot][name], rows_j)
            if name not in ("k", "v"):
                pools[slot][name] = rows_j
                continue
            pool = np.zeros((rows_j.shape[0], n_blocks, bs) + rows_j.shape[3:],
                            np.float32)
            for i in range(b):
                for j in range(s // bs):
                    pool[:, tables[i, j]] = rows_j[:, i, j * bs:(j + 1) * bs]
            pools[slot][name] = pool
    jpool = jax.tree.map(jnp.asarray, pools)
    tpool = jax.tree.map(lambda a: torch.from_numpy(a.copy()), pools)
    pos = lens.copy()
    nxt = np.array(jnp.argmax(want[:, -1], -1), np.int32)
    ref_decode = jax.jit(ref_lm.decode_step, static_argnums=0,
                         static_argnames="n_kv_blocks")
    for _ in range(4):
        want, jpool = ref_decode(
            rc, rp, jnp.asarray(nxt[:, None]), jpool, jnp.asarray(pos),
            block_tables=jnp.asarray(tables), n_kv_blocks=4)
        got, tpool = lm.decode_step(c, p, torch.from_numpy(nxt[:, None]),
                                    tpool, torch.from_numpy(pos),
                                    block_tables=torch.from_numpy(tables),
                                    n_kv_blocks=4)
        _close(got, want)
        nxt = np.array(jnp.argmax(want[:, -1], -1), np.int32)
        pos = pos + 1
    for slot, leaves in jpool.items():
        for name, leaf in leaves.items():
            _close(tpool[slot][name], leaf)
            assert tpool[slot][name].dtype == DTYPES[leaf.dtype.name]
