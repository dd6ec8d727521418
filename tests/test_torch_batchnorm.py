"""The BatchNorm kernel pair's plumbing, on the CPU.

The kernels (``csrc/batchnorm.cu``) run only on a card
(``tests/test_torch_cuda.py -k batchnorm``); here:

  * ``plan`` cuts the rows of every ResNet50 BatchNorm call at batch 256,
    and of ragged ones, into chunks that cover them, none empty, each a
    whole number of block passes, the grid within the card's resident
    blocks (one wave);
  * ``kernels.ops.batchnorm`` on CPU tensors is the plain version, with
    each epilogue, and the kernel's wrapper refuses CPU tensors and an
    epilogue without its shortcut (or a shortcut without it);
  * ``chip_smoke.py``'s phase-5 BatchNorm row: the calls it records from
    the model are ResNet50's 53, and its agreement check passes the
    plain version's own outputs and refuses one off by two ulps.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.resnet50 import CONFIG as RESNET50
from repro_torch.kernels import batchnorm as bn
from repro_torch.kernels import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  phase 5's BatchNorm row

#: (M, C) of ResNet50's distinct BatchNorm calls at batch 256 (the first
#: twelve, held to the model by ``test_shapes_are_resnet50s_calls``), and
#: ragged ones (M not whole block passes, C not whole tiles)
SHAPES = [(3211264, 64), (802816, 64), (802816, 256), (802816, 128),
          (200704, 128), (200704, 512), (200704, 256), (50176, 256),
          (50176, 1024), (50176, 512), (12544, 512), (12544, 2048),
          (105, 40), (1, 64), (33, 8)]


@pytest.mark.parametrize("resident", [2, 3, 4, 5])
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("m,c", SHAPES)
def test_plan_covers_the_rows_in_one_wave(m, c, esize, resident):
    sms = 132
    chunks, per = bn.plan(m, c, esize, resident * sms)
    rows = bn.rows_per_pass(esize)
    tiles = -(-c // bn.TILE)
    assert per % rows == 0
    assert (chunks - 1) * per < m <= chunks * per
    assert chunks * tiles <= max(resident * sms, tiles)
    if tiles <= resident * sms and m >= rows * resident * sms:
        assert chunks * tiles > resident * sms // 2     # the card is full


@pytest.mark.parametrize("act", ["none", "relu", "add_relu"])
def test_ops_batchnorm_on_the_cpu_is_the_plain_version(act):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 3, 5, generator=g).to(
        memory_format=torch.channels_last)
    scale, bias = torch.randn(16, generator=g), torch.randn(16, generator=g)
    sc = torch.randn(x.shape, generator=g) if act == "add_relu" else None
    got = ops.batchnorm(x, scale, bias, act=act, residual=sc)
    want = ref.bn_epilogue(
        torch.nn.functional.batch_norm(x, None, None, scale, bias,
                                       training=True, eps=1e-5), act, sc)
    assert torch.equal(got, want)


def test_the_kernel_wrapper_refuses_what_it_does_not_take():
    x = torch.ones(2, 64, 3, 3).to(memory_format=torch.channels_last)
    w = torch.ones(64)
    with pytest.raises(ValueError, match="CUDA kernel"):
        bn.forward(x, w, w)
    with pytest.raises(ValueError, match="add_relu"):
        bn.forward(x, w, w, act="add_relu")
    with pytest.raises(ValueError, match="add_relu"):
        bn.forward(x, w, w, act="relu", residual=x)
    with pytest.raises(ValueError, match="act must be"):
        bn.forward(x, w, w, act="gelu")


def test_shapes_are_resnet50s_calls():
    """The calls that phase 5 records from the model's forward: the
    stem, then each block's projection (where it has one), bn1, bn2 and
    bn3, 53 in all, whose distinct (M, C) at batch 256 are SHAPES'
    first twelve."""
    calls = chip_smoke.resnet_bn_calls(RESNET50, 256, torch.device("cpu"))
    assert len(calls) == 53
    assert calls[0] == (3211264, 64, "relu")
    assert [a for *_, a in calls].count("add_relu") == 16
    assert [a for *_, a in calls].count("none") == 4
    assert sorted({(m, c) for m, c, _ in calls}) == sorted(SHAPES[:12])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu", "add_relu"])
def test_phase5_agreement_check(act, dtype):
    """``chip_smoke.bn_agreement`` passes the plain version's own output
    and gradients through autograd (equal in fp32; in bf16 dscale and
    dbias are rounded to the params' type); dx two ulps off at one
    element, or a d_sc off, fails it."""
    g = torch.Generator().manual_seed(1)

    def t(mu=0.0):
        return (torch.randn(4, 6, 5, 16, generator=g) + mu).to(
            dtype).permute(0, 3, 1, 2)

    x, dy = t(0.5), t()
    sc = t() if act == "add_relu" else None
    scale = (torch.rand(16, generator=g) + 0.5).to(dtype)
    bias = (torch.randn(16, generator=g) * 0.1).to(dtype)
    leaves = [u.clone().requires_grad_(True)
              for u in (x, scale, bias, sc) if u is not None]
    y = ops.batchnorm(*leaves[:3], act=act,
                      residual=leaves[3] if sc is not None else None)
    got = torch.autograd.grad(y, leaves, dy)
    grads = (got[0], got[3] if sc is not None else None, got[1], got[2])
    y = y.detach()
    err = chip_smoke.bn_agreement(x, scale, bias, sc, dy, act, y, grads)
    assert err == 0.0 or dtype == torch.bfloat16
    dx = grads[0].clone()
    dx[0, 3, 2, 1] += 2 * chip_smoke.bn_ulp(dx[0, 3, 2, 1].float()) \
        if dtype == torch.bfloat16 else 1.0
    with pytest.raises(AssertionError, match="dx"):
        chip_smoke.bn_agreement(x, scale, bias, sc, dy, act, y,
                                (dx,) + grads[1:])
    if act == "add_relu":
        dsc = grads[1].clone()
        dsc[1, 2, 3, 4] += 1
        with pytest.raises(AssertionError, match="d_sc"):
            chip_smoke.bn_agreement(x, scale, bias, sc, dy, act, y,
                                    (grads[0], dsc) + grads[2:])
