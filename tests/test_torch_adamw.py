"""The multi-tensor AdamW kernel's work plan and dispatch, on the CPU.

The kernel itself (``csrc/adamw.cu``) runs only on the card, where
``tests/test_torch_cuda.py`` holds it to the plain loop. Here:

  * :func:`kernels.adamw.plan` covers every element of every leaf
    exactly once, no item crosses a leaf, a leaf's items are consecutive
    and the kernel's lookup rule (the last leaf whose first item is at
    most the item) finds each item's leaf; empty, 0-d and one-element
    leaves, chunk boundaries, launches split by the table's size, and a
    leaf of more than 2**31 elements planned from its shape alone;
  * CPU leaves take the plain loop and launch nothing; the kernel's
    wrapper refuses CPU tensors (no fallback); ``launch_counts`` lists
    ``adamw``;
  * the card path's plumbing (``optimizer._adamw_card``: the norm and
    update leaf lists, ZeRO slices, the hyper-parameters) with the kernel
    replaced by a Python model of it that follows the plan item by item,
    against the plain loop.
"""
import bisect
import math

import pytest
import torch

from repro_torch.core import tree
from repro_torch.kernels import adamw as fused
from repro_torch.kernels import ops
from repro_torch.train import optimizer

SHAPE_SETS = {
    "edge": [(0,), (), (1,), (5, 0), (3,)],
    "chunk": [(fused.CHUNK,), (fused.CHUNK + 1,), (fused.CHUNK - 1,),
              (2, fused.CHUNK), (7, 3, 5)],
    "resnet_like": [(7, 7, 3, 64), (64,), (64,), (1, 1, 64, 256),
                    (3, 3, 512, 512), (2048,), (2048, 1000), (1000,)],
    "stacked_lm": [(24, 1536, 4608), (24, 1536), (), (50432, 1536),
                   (24, 6144, 1536)],
}


def _items(numels, group, chunk=fused.CHUNK):
    """``(leaf, offset, count)`` of each item of ``group`` in item order,
    by the kernel's rule: item ``j`` belongs to the last leaf whose first
    item is at most ``j``, at offset ``(j - first) * chunk``."""
    for leaf, first, nxt in zip(group.leaves, group.first,
                                group.first[1:] + (group.items,)):
        for j in range(first, nxt):
            off = (j - first) * chunk
            yield leaf, off, min(chunk, numels[leaf] - off)


def _check_plan(numels, max_leaves, chunk=fused.CHUNK):
    groups = fused.plan(numels, max_leaves, chunk)
    covered = {}
    seen = []
    for grp in groups:
        assert 0 < len(grp.leaves) <= max_leaves
        assert 0 < grp.items <= fused.MAX_ITEMS
        assert list(grp.first) == sorted(set(grp.first))
        assert grp.first[0] == 0
        seen += grp.leaves
        for j, (leaf, off, count) in enumerate(_items(numels, grp, chunk)):
            # the kernel's rule: the last leaf whose first item is <= j
            k = bisect.bisect_right(grp.first, j) - 1
            assert grp.leaves[k] == leaf
            assert off == (j - grp.first[k]) * chunk
            assert 1 <= count <= chunk and off + count <= numels[leaf]
            assert covered.get(leaf, 0) == off   # consecutive, no overlap
            covered[leaf] = off + count
    assert seen == sorted(seen) and len(seen) == len(set(seen))
    assert covered == {i: n for i, n in enumerate(numels) if n}
    return groups


@pytest.mark.parametrize("name", sorted(SHAPE_SETS))
@pytest.mark.parametrize("max_leaves", [1, 2, fused.MAX_UPDATE_LEAVES])
def test_plan_covers_every_element_once_within_its_leaf(name, max_leaves):
    numels = [math.prod(s) for s in SHAPE_SETS[name]]
    groups = _check_plan(numels, max_leaves)
    with_elements = sum(1 for n in numels if n)
    assert len(groups) == -(-with_elements // max_leaves)


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_plan_at_small_chunks(chunk):
    _check_plan([0, 1, 2, 3, 64, 65, 0, 129], 3, chunk)


def test_plan_of_a_leaf_past_two_to_the_31_from_its_shape_alone():
    """No tensor is made: the plan reads element counts. Item offsets pass
    2**31 (the kernel's offsets are 64-bit); the item count stays an
    int32 grid."""
    shape = (2 ** 16, 2 ** 15 + 3)
    n = math.prod(shape)
    assert n > 2 ** 31
    numels = [5, n, 1]
    groups = _check_plan(numels, fused.MAX_UPDATE_LEAVES)
    (grp,) = groups
    last = list(_items(numels, grp))[-2]
    assert last[0] == 1 and last[1] > 2 ** 31
    assert last[1] + last[2] == n
    assert grp.items == 1 + -(-n // fused.CHUNK) + 1


def test_plan_splits_a_tree_larger_than_one_table():
    numels = [3] * (2 * fused.MAX_UPDATE_LEAVES + 1)
    groups = _check_plan(numels, fused.MAX_UPDATE_LEAVES)
    assert [len(g.leaves) for g in groups] == [fused.MAX_UPDATE_LEAVES] * 2 \
        + [1]
    assert [len(g.leaves) for g in fused.plan(
        numels, fused.MAX_NORM_LEAVES)] == [fused.MAX_NORM_LEAVES, 121]


def test_plan_refuses_a_leaf_beyond_one_launch():
    with pytest.raises(ValueError, match="items"):
        fused.plan([fused.MAX_ITEMS + 1], 4, chunk=1)


def test_table_layouts_match_the_source():
    """The numpy tables have the C structs' sizes and field offsets
    (``static_assert`` in the source; the wrapper also checks the built
    library's sizes before its first launch)."""
    src = (fused.__file__.rsplit("/kernels/", 1)[0] + "/csrc/adamw.cu")
    text = open(src).read()
    assert f"kChunk = {fused.CHUNK};" in text
    assert f"kMaxNormLeaves = {fused.MAX_NORM_LEAVES};" in text
    assert f"kMaxUpdateLeaves = {fused.MAX_UPDATE_LEAVES};" in text
    assert f"sizeof(NormLeaf) == {fused.NORM_LEAF.itemsize}" in text
    assert f"sizeof(UpdateLeaf) == {fused.UPDATE_LEAF.itemsize}" in text
    for flag, value in (("kParamBf16", fused.PARAM_BF16),
                        ("kDecay", fused.DECAY), ("kVector", fused.VECTOR)):
        assert f"{flag} = {value};" in text
    assert fused.NORM_LEAF.names == ("g", "numel", "first", "flags", "div")
    assert fused.UPDATE_LEAF.names == ("g", "m", "v", "master", "p", "numel",
                                       "first", "flags")


def _state(seed, shapes, pdtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    params = {k: torch.randn(s, generator=g).to(pdtype)
              for k, s in shapes.items()}
    return params, optimizer.adamw_init(optimizer.OptConfig(), params)


def _grads(seed, shapes, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g) * scale for k, s in shapes.items()}


SHAPES = {"w": (6, 5, 8), "b": (7, 3), "s": (), "e": (2, 600), "z": (0, 4)}


def test_cpu_leaves_take_the_plain_loop_and_launch_nothing():
    ops.reset_launch_counts()
    oc = optimizer.OptConfig(warmup=1)
    p, o = _state(0, SHAPES, torch.bfloat16)
    p2, o2 = tree.tree_map(torch.clone, (p, o))
    for i in range(2):
        grads = _grads(i, SHAPES)
        _, _, info = optimizer.adamw_update(oc, grads, o, p)
        step = o2["step"] + 1
        lr = optimizer.lr_at(oc, step)
        gn = optimizer.adamw_leaves_ref(
            oc, tree.leaves(grads), tree.leaves(o2["m"]),
            tree.leaves(o2["v"]), tree.leaves(o2["master"]),
            tree.leaves(p2), lr, 1 - oc.b1 ** step.float(),
            1 - oc.b2 ** step.float())
        o2["step"] = step
        assert torch.equal(info["gnorm"], gn)
    for a, b in zip(tree.leaves((p, o)), tree.leaves((p2, o2)), strict=True):
        assert torch.equal(a, b)
    assert ops.launch_counts()["adamw"] == 0
    assert fused.adamw.launches == 0


def test_launch_counts_list_adamw():
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    assert "adamw" in counts and counts["adamw"] == 0
    assert ops.KERNELS["adamw"] is fused.adamw


def test_the_kernel_refuses_cpu_tensors():
    ops.reset_launch_counts()
    p, o = _state(0, {"w": (3, 4)})
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA kernel called"):
        fused.adamw([p["w"]], [p["w"]], [o["m"]["w"]], [o["v"]["w"]],
                    [o["master"]["w"]], [p["w"]], lr=one, bc1=one, bc2=one,
                    b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip=1.0)
    assert fused.adamw.launches == 0


def _model_kernel(norm_grads, grads, m, v, master, params, *, lr, bc1, bc2,
                  b1, b2, eps, weight_decay, clip, norm_divisors=None,
                  reduce=None):
    """The kernel's contract on the CPU, item by item along the plan:
    fp64 partial squares per item (over its leaf's divisor), their sum
    through ``reduce``, the scale, then the update of each item's
    elements in the plain loop's fp32 ops."""
    nums = [g.numel() for g in norm_grads]
    div = norm_divisors or [1] * len(nums)
    partials = []
    for grp in fused.plan(nums, fused.MAX_NORM_LEAVES):
        for leaf, off, count in _items(nums, grp):
            x = norm_grads[leaf].reshape(-1)[off:off + count].double()
            partials.append(float((x * x).sum()) / div[leaf])
    sq = torch.tensor([sum(partials)], dtype=torch.float64)
    if reduce is not None:
        sq = reduce(sq)
    gnorm = torch.sqrt(sq.float().reshape(()))
    scale = torch.clamp(clip * (1 / torch.clamp(gnorm, min=1e-12)),
                        max=1.0)
    nums = [g.numel() for g in grads]
    flat = [[t.reshape(-1) for t in x] for x in (grads, m, v, master,
                                                  params)]
    for grp in fused.plan(nums, fused.MAX_UPDATE_LEAVES):
        for leaf, off, count in _items(nums, grp):
            gp, mp, vp, wp, pp = (x[leaf][off:off + count] for x in flat)
            gp = gp.float() * scale
            mp.mul_(b1).add_((1 - b1) * gp)
            vp.mul_(b2).add_((1 - b2) * torch.square(gp))
            d = (mp / bc1).div_(torch.sqrt(vp / bc2).add_(eps))
            if master[leaf].ndim >= 1:
                d.add_(weight_decay * wp)
            wp.sub_(lr * d)
            pp.copy_(wp)
    fused.adamw.launches += 3
    return gnorm


@pytest.mark.parametrize("clip", [1e6, 0.5])
@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_card_path_plumbing_against_the_plain_loop(monkeypatch, clip,
                                                   pdtype):
    """``_adamw_card`` hands the kernel the plain loop's leaves and
    hyper-parameters: with a model of the kernel it gives the plain
    loop's state, to the bit where the clip is not engaged (the scale is
    1 on both sides) and within fp32 rounding of the norm where it is
    (the norm's partial sums run in another order)."""
    monkeypatch.setattr(optimizer, "adamw_kernel", _model_kernel)
    ops.reset_launch_counts()
    shapes = dict(SHAPES, big=(3, fused.CHUNK + 5))
    oc = optimizer.OptConfig(warmup=1, grad_clip=clip)
    p, o = _state(1, shapes, pdtype)
    p2, o2 = tree.tree_map(torch.clone, (p, o))
    for i in range(3):
        grads = tree.leaves(_grads(10 + i, shapes))
        step = o["step"] + 1
        lr = optimizer.lr_at(oc, step)
        bc = (1 - oc.b1 ** step.float(), 1 - oc.b2 ** step.float())
        leaves = lambda p_, o_: (tree.leaves(o_["m"]), tree.leaves(o_["v"]),
                                 tree.leaves(o_["master"]), tree.leaves(p_))
        gn = optimizer._adamw_card(oc, grads, *leaves(p, o), lr, *bc)
        gn2 = optimizer.adamw_leaves_ref(oc, grads, *leaves(p2, o2), lr,
                                         *bc)
        o["step"] = o2["step"] = step
        torch.testing.assert_close(gn, gn2, rtol=1e-6, atol=0)
    exact = clip > 1e3
    for a, b in zip(tree.leaves((p, o)), tree.leaves((p2, o2)), strict=True):
        if exact:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert ops.launch_counts()["adamw"] == 9


class _OneRankZero:
    """A ZeRO layout stand-in on one process: the leaves listed in
    ``cut`` are sliced to their first half along dim 0 (what
    ``Zero1.local`` gives rank 0 of two), the gather puts the slice back
    beside the untouched other half, and ``replicas`` counts 2 for a
    sliced leaf."""

    def __init__(self, full_params, cut):
        self.cuts = [[(0, ("data",))] if i in cut else []
                     for i in range(len(full_params))]
        self.rest = {i: full_params[i][full_params[i].shape[0] // 2:].clone()
                     for i in cut}
        self.mesh = self

    def local(self, i, t):
        return t[:t.shape[0] // 2]

    def gather(self, i, part):
        return torch.cat([part, self.rest[i]])

    def replicas(self, i, zero=True):
        return 2 if self.cuts[i] else 1

    axis_names = ("data",)

    def all_reduce(self, t, axes):
        return t


@pytest.mark.parametrize("sharded", [False, True])
def test_card_path_zero_slices_against_the_plain_loop(monkeypatch, sharded):
    """Under a ZeRO layout the card path updates each cut leaf's slice
    into a buffer of the param's type and gathers it, with the norm over
    the whole gradients (ZeRO-1) or the slices over their replicas
    (ZeRO-2), as the plain loop does."""
    monkeypatch.setattr(optimizer, "adamw_kernel", _model_kernel)
    shapes = {"a": (8, 5), "b": (6,), "c": (4, 3, 2)}
    oc = optimizer.OptConfig(warmup=1, grad_clip=1e6)
    p, _ = _state(2, shapes, torch.bfloat16)
    cut = {0, 2}
    pl = tree.leaves(p)
    zero = _OneRankZero(pl, cut)
    z_state = optimizer.adamw_init(oc, p)
    for k in ("m", "v", "master"):
        z_state[k] = tree.unflatten(z_state[k], [
            zero.local(i, t).clone() if i in cut else t
            for i, t in enumerate(tree.leaves(z_state[k]))])
    p2, o2 = tree.tree_map(torch.clone, (p, z_state))
    for i in range(2):
        grads = tree.leaves(_grads(20 + i, shapes))
        if sharded:
            grads = [zero.local(j, g) if j in cut else g
                     for j, g in enumerate(grads)]
        step = z_state["step"] + 1
        lr = optimizer.lr_at(oc, step)
        bc = (1 - oc.b1 ** step.float(), 1 - oc.b2 ** step.float())
        runs = []
        for pp, oo, fn in ((p, z_state, optimizer._adamw_card),
                           (p2, o2, optimizer.adamw_leaves_ref)):
            runs.append(fn(oc, grads, tree.leaves(oo["m"]),
                           tree.leaves(oo["v"]), tree.leaves(oo["master"]),
                           tree.leaves(pp), lr, *bc, zero, sharded))
            oo["step"] = step
        torch.testing.assert_close(runs[0], runs[1], rtol=1e-6, atol=0)
    for a, b in zip(tree.leaves((p, z_state)), tree.leaves((p2, o2)),
                    strict=True):
        assert torch.equal(a, b)
    assert [t.shape[0] for t in tree.leaves(z_state["m"])] == [4, 6, 2]
