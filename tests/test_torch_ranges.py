"""The port's profiler ranges (``core.ranges``), on the CPU.

  * ``bracket`` puts its range around the backward of what it wraps:
    nested brackets give nested ranges, siblings disjoint ones, an
    unused input gets no gradient, and the numbers are the plain ones;
  * a profiled ResNet step and a profiled LM step hold ``forward``,
    ``backward`` and ``optimizer``; the ResNet step holds two
    ``batchnorm`` ranges a BatchNorm call, one inside ``forward`` and
    one inside ``backward`` on the thread that opened it;
  * with no profiler active the port enters no ``record_function``
    range and puts no marker node into the loss's autograd graph, and a
    profiled step's loss, gradients and updated params equal the
    unprofiled step's to the bit.

On the CPU autograd runs the backward on the calling thread; on a card
it runs it on a worker thread of its own, which ``chip_smoke.py``'s
train phases show.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.configs.resnet50 import CONFIG as RESNET
from repro_torch.core import ranges, tree
from repro_torch.data.synthetic import synthetic_images
from repro_torch.models import resnet
from repro_torch.train import step as train_step
from repro_torch.train.optimizer import OptConfig

torch.set_num_threads(1)

MARKERS = {"_CloseBackward"}


def _annotations(prof, tmp_path) -> dict:
    """``{name: [(t0, t1, tid), ...]}`` of the exported trace's ranges."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out: dict = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            t0 = float(e["ts"])
            out.setdefault(e["name"], []).append(
                (t0, t0 + float(e["dur"]), e["tid"]))
    return out


def _inside(r, outer) -> bool:
    return r[2] == outer[2] and outer[0] <= r[0] and r[1] <= outer[1]


def _profiled(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _annotations(prof, tmp_path)


# ---------------------------------------------------------------------------
# The helper
# ---------------------------------------------------------------------------


def _toy(a, b):
    """Two bracketed siblings inside a bracketed whole; ``b`` unused.
    The whole brackets leaves (an identity closes its range), each
    sibling a tensor that a node made (a hook closes its range)."""
    m = torch.linspace(-1.0, 1.0, a.numel()).reshape(a.shape)

    def whole(x, y):
        h = ranges.bracket("left", lambda v: (v @ m).relu(), x * 1.5)
        k = ranges.bracket("right", lambda v: v.tanh() * 3, x - 1.0)
        return h.sum() + k.sum(), y.detach().sum()
    with ranges.span("fwd"):
        loss, aux = ranges.bracket("whole", whole, a, b)
    return loss, aux, torch.autograd.grad(loss, [a, b], allow_unused=True)


def test_bracket_ranges_nest_around_the_backward(tmp_path):
    a = torch.randn(16, 16, requires_grad=True)
    b = torch.randn(4, requires_grad=True)
    plain = _toy(a, b)
    got, ann = _profiled(lambda: _toy(a, b), tmp_path)
    assert {k: len(v) for k, v in ann.items()} == {
        "fwd": 1, "whole": 1, "left": 1, "right": 1}
    (whole,), (left,), (right,) = ann["whole"], ann["left"], ann["right"]
    assert _inside(left, whole) and _inside(right, whole)
    assert left[1] <= right[0] or right[1] <= left[0]     # disjoint
    assert ann["fwd"][0][1] <= whole[0]      # the backward follows
    assert got[2][1] is None and plain[2][1] is None      # b unused
    assert torch.equal(got[0], plain[0])
    assert torch.equal(got[2][0], plain[2][0])
    assert isinstance(got[1], torch.Tensor) and torch.equal(got[1], plain[1])


def test_bracket_passes_through_without_grad_or_profiler():
    a = torch.randn(3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            assert ranges.bracket("x", torch.exp, a).grad_fn is None
        y = ranges.bracket("x", torch.exp, a.detach())
        assert y.grad_fn is None
    y = ranges.bracket("x", torch.exp, a)
    assert type(y.grad_fn).__name__ == "ExpBackward0"


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


def _resnet_case():
    c = RESNET.reduced()
    oc = OptConfig(warmup=2, total_steps=100)
    p, o = train_step.init_train_state(
        c, oc, torch.Generator().manual_seed(0), "cpu")
    imgs, labels = synthetic_images(4, c.img_size, c.n_classes, seed=0)
    batch = {"images": torch.from_numpy(imgs),
             "labels": torch.from_numpy(labels)}
    return train_step.make_resnet_train_step(c, oc), p, o, batch


def _lm_case():
    c = get_config("gpt-117m").reduced()
    oc = OptConfig(warmup=2, total_steps=100)
    p, o = train_step.init_train_state(
        c, oc, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, c.vocab, (2, 16), generator=g)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    return train_step.make_train_step(c, oc), p, o, batch


CASES = {"resnet": _resnet_case, "lm": _lm_case}


def _run_step(case, profiled: bool, tmp_path=None):
    """One step from the case's fresh state: ``(loss, grads, params,
    ranges)``; the grads are the step's ``value_and_grad`` of the same
    state and batch."""
    step, p, o, batch = CASES[case]()
    seen = []
    real = torch.autograd.grad

    def grad(outputs, inputs, **kw):
        out = real(outputs, inputs, **kw)
        seen.append([None if g is None else g.clone() for g in out])
        return out

    def go():
        torch.autograd.grad = grad
        try:
            return step(p, o, batch)
        finally:
            torch.autograd.grad = real

    if profiled:
        (_p, _o, m), ann = _profiled(go, tmp_path)
    else:
        (_p, _o, m), ann = go(), {}
    return m["loss"], seen[0], tree.leaves(p), ann


@pytest.mark.parametrize("case", sorted(CASES))
def test_profiled_step_holds_the_layer_ranges(case, tmp_path,
                                              monkeypatch):
    calls = []
    real_bn = resnet._batchnorm
    monkeypatch.setattr(resnet, "_batchnorm",
                        lambda *a: calls.append(1) or real_bn(*a))
    *_, ann = _run_step(case, True, tmp_path)
    assert len(ann["forward"]) == len(ann["backward"]) == 1
    assert len(ann["optimizer"]) == 1
    fwd, bwd = ann["forward"][0], ann["backward"][0]
    assert fwd[1] <= bwd[0] <= bwd[1] <= ann["optimizer"][0][0]
    assert "forward_backward" not in ann
    if case == "lm":
        assert "batchnorm" not in ann and not calls
        return
    bn = ann["batchnorm"]
    assert len(calls) == 17                  # stem + 4 x 3 + 4 projections
    assert len(bn) == 2 * len(calls)
    back = [r for r in bn if _inside(r, bwd)]
    assert len(back) == len(calls)
    assert all(_inside(r, fwd) for r in bn if r not in back)


@pytest.mark.parametrize("case", sorted(CASES))
def test_profiled_step_equals_the_plain_step_to_the_bit(case, tmp_path):
    plain = _run_step(case, False)
    traced = _run_step(case, True, tmp_path)
    assert torch.equal(plain[0], traced[0])
    for a, b in zip(plain[1], traced[1], strict=True):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    for a, b in zip(plain[2], traced[2], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_without_a_profiler_no_range_and_no_marker_node(case, monkeypatch):
    entered = []

    class Counting(ranges.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(ranges, "record_function", Counting)
    made = []
    real_init = ranges._Backward.__init__
    monkeypatch.setattr(ranges._Backward, "__init__",
                        lambda self, name: made.append(name)
                        or real_init(self, name))
    nodes = {False: set(), True: set()}
    real = torch.autograd.grad

    def walk(outputs, inputs, **kw):
        todo, seen = [outputs.grad_fn], set()
        while todo:
            f = todo.pop()
            if f is not None and f not in seen:
                seen.add(f)
                nodes[profiled].add(type(f).__name__)
                todo += [n for n, _ in f.next_functions]
        return real(outputs, inputs, **kw)

    monkeypatch.setattr(torch.autograd, "grad", walk)
    step, p, o, batch = CASES[case]()
    profiled = False
    step(p, o, batch)
    assert entered == [] and made == []
    assert not nodes[False] & MARKERS
    profiled = True                          # the positive control
    with profile(activities=[ProfilerActivity.CPU]):
        step(p, o, batch)
    assert {"forward", "backward", "optimizer"} <= set(entered)
    assert "backward" in made
    assert MARKERS <= nodes[True]
