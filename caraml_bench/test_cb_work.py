"""The work formulas against ``torch.utils.flop_counter.FlopCounterMode``
on the plain references at a tiny size (forward and backward, nothing
recomputed), and the invariants the readers rest on."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cb_testkit import tiny
from cbench import weights
from cbench.reference import lm as ref_lm
from cbench.reference import resnet as ref_resnet
from cbench.reference.lowp import Precision
from cbench.traffic import Feed
from cbench.work import Op, least_seconds, matmul, total_flops
from cbench.work import lm as work_lm
from cbench.work import resnet as work_resnet
from cbench.models import lm as m_lm
from cbench.models import resnet as m_resnet


def _counted(cell, loss_and_grads, specs):
    P = {n: t.float() for n, t in
         weights.make(specs, 3, "cpu", torch.float32).items()}
    batch = Feed(cell.traffic, cell.config, 3, "cpu").next()
    with FlopCounterMode(display=False) as fc:
        loss_and_grads(cell.config, P, batch, Precision(), remat=False)
    return fc.get_total_flops()


def test_lm_formula_is_what_the_reference_multiplies():
    cell = tiny("gpt800m-s2048-gb16")
    cell.traffic["microbatches"] = 1
    counted = _counted(cell, ref_lm.loss_and_grads,
                       m_lm.leaf_specs(cell.config))
    ops = work_lm.step_ops(cell.config, cell.traffic, causal=False)
    assert total_flops(ops) == counted


def test_lm_causal_half_counts_the_visible_pairs():
    cell = tiny("gpt800m-s2048-gb16")
    full = work_lm.step_ops(cell.config, cell.traffic, causal=False)
    half = work_lm.step_ops(cell.config, cell.traffic, causal=True)
    s, c = cell.traffic["seq_len"], cell.config
    att = [o for o in full if o.name == "attention"][0]
    att_c = [o for o in half if o.name == "attention"][0]
    assert att_c.flops / att.flops == pytest.approx((s + 1) / (2 * s))
    assert att_c.count == c["n_layers"] * cell.traffic["microbatches"]
    assert total_flops(full) - total_flops(half) == pytest.approx(
        att.count * (att.flops - att_c.flops))


def test_resnet_formula_is_what_the_reference_convolves():
    cell = tiny("resnet50-b256")
    counted = _counted(cell, ref_resnet.loss_and_grads,
                       m_resnet.leaf_specs(cell.config))
    assert total_flops(work_resnet.step_ops(cell.config,
                                            cell.traffic)) == counted


def test_resnet_forward_matches_the_published_count():
    """ResNet50 at 224: 4.09 G multiply-adds an image forward (He et
    al.), so 3 x 8.18 GFLOP a training image, less the stem's input
    gradient."""
    from cbench.spec import find_cell, load_benchmark
    cell = find_cell(load_benchmark(), "resnet50-b256")
    ops = work_resnet.step_ops(cell.config, dict(global_batch=1))
    fwd = sum(o.flops / (2 if o.name == "stem" else 3) for o in ops)
    assert fwd == pytest.approx(8.18e9, rel=0.01)


def test_least_time_is_bounded_by_operations_and_bytes():
    ops = [matmul("big", 4096, 4096, 4096), matmul("thin", 8192, 16, 8192),
           Op("x", 10.0, 1e9, 2)]
    t = least_seconds(ops, 1e12, 1e9)
    assert t >= total_flops(ops) / 1e12
    assert t >= sum(o.bytes * o.count for o in ops) / 1e9 / len(ops)
    assert t == pytest.approx(sum(o.count * max(o.flops / 1e12,
                                                o.bytes / 1e9) for o in ops))
