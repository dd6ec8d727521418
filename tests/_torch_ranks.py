"""Rank functions for the port's multi-rank tests.

``launch.mesh.spawn`` pickles a rank function by its import path and
each rank imports its module afresh, so these live here, importing only
``torch``, ``numpy`` and ``repro_torch`` (a test module would pull JAX
into every rank). Each function is ``fn(world, *args)`` and returns
numpy results for the test to hold against the reference's.
"""
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.bench.spec import Placement
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.resnet50 import CONFIG as RESNET
from repro_torch.core import tree
from repro_torch.launch.mesh import make_mesh, mesh_for
from repro_torch.parallel import grad_sync as gs
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.compress import (compressed_psum,
                                          make_compressed_grad_sync,
                                          shared_codes)
from repro_torch.train.optimizer import OptConfig, opt_init, opt_update
from repro_torch.train.step import (StepConfig, make_resnet_train_step,
                                    make_train_step)

F32 = dict(dtype="float32", param_dtype="float32")
LM_OPT = dict(warmup=2, total_steps=100)


def lm_config():
    return get_config("gpt-117m").reduced(**F32)


def resnet_config():
    return RESNET.reduced(img_size=32, width=8, **F32)


def _np_leaves(t) -> list:
    return [x.detach().numpy().copy() for x in tree.leaves(t)]


def _lm_batch(toks: np.ndarray) -> dict:
    t = torch.from_numpy(toks)
    return {"tokens": t, "labels": torch.roll(t, -1, 1)}


def dp_lm_cases(world, placement: str, params_np, batches: list,
                cases: list) -> dict:
    """For each ``(mode, overlap, k)``: three dp steps of the bucketed
    step from the reference's weights; the losses, the params, the
    gathered AdamW state and this rank's sync state."""
    c, oc = lm_config(), OptConfig(**LM_OPT)
    plan = shd.make_plan(c, mesh_for(Placement.of(placement)),
                         ShapeConfig("t", 0, 0, "train"))
    out = {}
    for mode, overlap, k in cases:
        p = bridge.params_from_numpy(params_np, device="cpu")
        p, o, zero = shd.shard_train_state(plan, p, opt_init(oc, p), c)
        sync = gs.GradSyncConfig(mode=mode, bucket_mb=0.01, overlap=overlap)
        step = gs.make_dp_train_step(c, oc, StepConfig(microbatches=k),
                                     plan=plan, sync=sync, zero=zero)
        s = gs.init_sync_state(p, sync)
        losses = []
        for toks in batches:
            p, o, s, m = step(p, o, s, _lm_batch(toks))
            losses.append(float(m["loss"]))
        full = shd.gather_opt_state(zero, o)
        out[(mode, overlap, k)] = {
            "losses": losses, "params": _np_leaves(p),
            "opt": _np_leaves({k_: full[k_] for k_ in ("m", "v",
                                                        "master")}),
            "sync": s.numpy().copy()}
    return out


def sync_and_update_checks(world, seed: int) -> dict:
    """On each rank's own random gradients (rank-seeded): the bucketed
    fp32 sync against the per-leaf all-reduce, the int8 buckets' summed
    codes against the shared scale's codes summed by hand, and the
    ZeRO-1 AdamW update against the replicated one (bits); and one
    plain dp step on a batch whose ranks count unequal loss tokens
    beside one rank's step on the whole batch."""
    c = lm_config()
    mesh = make_mesh((world.world_size, 1), ("data", "model"))
    plan = shd.make_plan(c, mesh, ShapeConfig("t", 0, 0, "train"))
    group = mesh.group(plan.dp)
    gen = torch.Generator().manual_seed(seed)
    from repro_torch.models import lm
    params = lm.init(c, gen, "cpu")
    rgen = torch.Generator().manual_seed(seed + 1 + world.rank)
    grads = tree.tree_map(
        lambda x: torch.randn(x.shape, generator=rgen), params)
    out = {}
    sync = gs.GradSyncConfig(mode="fp32", bucket_mb=0.01)
    bucketed, _ = gs.sync_grads(grads, sync, None, group)
    naive = gs.naive_psum_sync(grads, group)
    out["naive_vs_bucketed"] = max(
        float((a - b).abs().max()) for a, b in
        zip(tree.leaves(bucketed), tree.leaves(naive)))
    # int8: the mean's codes are the sum of every rank's codes
    buckets, _ = gs.flatten_buckets(grads, sync.bucket_elems)
    red, err = compressed_psum(buckets, None, group)
    q, scale = shared_codes(buckets.float(), group)
    summed = q.to(torch.int32)
    dist.all_reduce(summed, group=group)
    out["int8_codes"] = bool(torch.equal(
        torch.round(red * world.world_size / scale).to(torch.int32),
        summed))
    out["int8_residual"] = float((buckets - q * scale - err).abs().max())
    # the per-leaf form: each leaf's int8 mean within one quantization
    # step (its largest |g| over the ranks / 127) of the fp32 mean
    per_leaf, _ = make_compressed_grad_sync(group)(
        grads, tree.tree_map(torch.zeros_like, grads))
    steps = []
    for g, got, want in zip(tree.leaves(grads), tree.leaves(per_leaf),
                            tree.leaves(naive)):
        amax = g.abs().max().reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        steps.append(float((got - want).abs().max() / (amax / 127)))
    out["per_leaf_steps"] = max(steps)
    # ZeRO-1 vs replicated AdamW on the same synced gradients
    oc = OptConfig(**LM_OPT)
    p_rep = tree.tree_map(torch.Tensor.clone, params)
    o_rep = opt_init(oc, p_rep)
    p_z, o_z, zero = shd.shard_train_state(
        plan, tree.tree_map(torch.Tensor.clone, params),
        opt_init(oc, params), c)
    assert zero.sliced
    for _ in range(3):
        opt_update(oc, naive, o_rep, p_rep)
        opt_update(oc, naive, o_z, p_z, zero)
    full = shd.gather_opt_state(zero, o_z)
    out["zero1_params_equal"] = all(
        torch.equal(a, b) for a, b in zip(tree.leaves(p_rep),
                                          tree.leaves(p_z)))
    out["zero1_state_equal"] = all(
        torch.equal(a, b) for k in ("m", "v", "master") for a, b in
        zip(tree.leaves(o_rep[k]), tree.leaves(full[k])))
    out["sliced_elems"] = sum(x.numel() for k in ("m", "v", "master")
                              for x in tree.leaves(o_z[k]))
    out["whole_elems"] = sum(x.numel() for k in ("m", "v", "master")
                             for x in tree.leaves(o_rep[k]))
    # rank 0's rows have 17 of their 32 labels masked, rank 1's none
    toks = torch.randint(0, c.vocab, (4, 16),
                         generator=torch.Generator().manual_seed(seed))
    batch = _lm_batch(toks.numpy())
    batch["labels"][0, :12] = -1
    batch["labels"][1, :5] = -1
    for name, pl in (("masked_dp", plan), ("masked_one", None)):
        p = tree.tree_map(torch.Tensor.clone, params)
        p, _, m = make_train_step(c, oc, plan=pl)(p, opt_init(oc, p), batch)
        out[name] = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
                     "params": _np_leaves(p)}
    return out


def dp_resnet_steps(world, placement: str, params_np, images, labels,
                    n_steps: int = 3) -> dict:
    """``n_steps`` of the dp ResNet step (BatchNorm synced over the
    ranks) from the reference's weights on one global batch."""
    c, oc = resnet_config(), OptConfig(warmup=2, total_steps=1000)
    plan = shd.make_dp_plan(mesh_for(Placement.of(placement)))
    p = bridge.params_from_numpy(params_np, device="cpu")
    p, o, zero = shd.shard_train_state(plan, p, opt_init(oc, p))
    step = make_resnet_train_step(c, oc, plan=plan, zero=zero)
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels)}
    losses = []
    for _ in range(n_steps):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": _np_leaves(p)}


def pipeline_outputs(world, params_np, x_np) -> dict:
    """The pp4 rotation-schedule forward of the reference's tiny
    gpt-117m layers, and the sequential forward of the same layers."""
    from repro_torch.bench.workloads.pipeline_gpt import (N_STAGES,
                                                          layer_fn_for)
    from repro_torch.parallel.pipeline import (pipeline_forward,
                                               stage_params_split)
    c = pipeline_config()
    layers = bridge.params_from_numpy(params_np, device="cpu")["layers"]
    mesh = mesh_for(Placement.of({"pp": N_STAGES}))
    x = torch.from_numpy(x_np)
    fn = layer_fn_for(c)
    with torch.no_grad():
        got = pipeline_forward(mesh, "stage", fn,
                               stage_params_split(layers, N_STAGES), x)
        seq = fn(layers, x.reshape(-1, *x.shape[2:]))
    return {"pipeline": got.numpy(), "sequential": seq.numpy()}


def pipeline_config():
    return get_config("gpt-117m").reduced(n_layers=4, d_model=64, d_ff=128,
                                          n_heads=2, n_kv_heads=2,
                                          d_head=32, vocab=512, **F32)


def train_rounds(world, params_np, ckpt_dir, total_steps: int,
                 ckpt_every: int) -> dict:
    """A dp run of the train loop from the reference's weights on
    step-indexed batches, checkpointing (rank 0 writes whole leaves) and
    resuming from ``ckpt_dir``: its losses and resume step (the final
    state is the checkpoint of ``total_steps``)."""
    from repro_torch.launch.train import make_data_fn
    from repro_torch.train.loop import LoopConfig, train_loop
    c = lm_config()
    oc = OptConfig(warmup=2, total_steps=100)
    mesh = make_mesh((world.world_size, 1), ("data", "model"))
    plan = shd.make_plan(c, mesh, ShapeConfig("t", 32, 8, "train"))
    p = bridge.params_from_numpy(params_np, device="cpu")
    p, o, zero = shd.shard_train_state(plan, p, opt_init(oc, p), c)
    step = make_train_step(c, oc, StepConfig(), plan=plan, zero=zero)
    data = make_data_fn(c, 8, 32, 0, "cpu")
    cfg = LoopConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                     ckpt_dir=ckpt_dir, log_every=0, seq_len=32,
                     global_batch=8)
    res = train_loop(step, p, o, data, cfg, dp=shd.DpCheckpoint(zero))
    return {"losses": res.losses, "resumed_from": res.resumed_from}


def fail_on_rank(world, bad_rank: int, how: str):
    """Rank ``bad_rank`` raises (or exits hard); the others wait in a
    collective for it."""
    if world.rank == bad_rank:
        if how == "exit":
            os._exit(3)
        raise ValueError(f"rank {bad_rank} failed on purpose")
    t = torch.ones(4)
    dist.all_reduce(t)
    time.sleep(60)
    return float(t.sum())


def mesh_layout(world) -> dict:
    """A (data 2, model 1, stage 2) mesh: this rank's coordinates, its
    groups' ranks, its rows of a 6-row batch under ``make_dp_plan`` and
    sums over its stage and data groups."""
    mesh = make_mesh((2, 1, 2), ("data", "model", "stage"))
    plan = shd.make_dp_plan(mesh)
    rows = shd.local_batch(plan, {"x": torch.arange(6)})["x"]
    sums = []
    for axes in ("stage", "data"):
        t = torch.tensor([float(world.rank)])
        dist.all_reduce(t, group=mesh.group(axes))
        sums.append(float(t))
    return {"coords": mesh.coords, "stage_ranks": mesh.ranks("stage"),
            "data_ranks": mesh.ranks("data"), "rows": rows.tolist(),
            "sums": sums}


def train_runs(world, params_np, runs: list) -> list:
    """:func:`train_rounds` for each ``(ckpt_dir, total_steps,
    ckpt_every)`` in turn, in one world."""
    return [train_rounds(world, params_np, *r) for r in runs]


# ---------------------------------------------------------------------------
# Tensor-, expert- and fully-sharded layouts
# ---------------------------------------------------------------------------


def sharded_config(arch: str, kw: dict):
    """A reduced fp32 config of ``arch`` with ``kw`` on top."""
    return get_config(arch).reduced(**{**F32, **kw})


def sharded_steps(world, arch: str, kw: dict, placement, params_np,
                  batches: list, opt: dict, k: int = 1,
                  force_fsdp=None, grads_of_first: bool = True,
                  flags: dict = None) -> dict:
    """Steps of the plan step (``make_train_step(plan=...)``) from whole
    weights on one global batch each: the metrics of each step, the whole
    params after the last (gathered), the first step's whole gradients,
    and this rank's param and optimizer-state elements. ``flags``: plan
    fields set on top of ``make_plan``'s (``seq_parallel``,
    ``moe_dshard``)."""
    import dataclasses
    c = sharded_config(arch, kw)
    oc = OptConfig(**{**LM_OPT, **opt})
    b, s = batches[0]["tokens"].shape
    plan = shd.make_plan(c, mesh_for(Placement.of(placement)),
                         ShapeConfig("t", s, b, "train"),
                         force_fsdp=force_fsdp)
    plan = dataclasses.replace(plan, **(flags or {}))
    p = bridge.params_from_numpy(params_np, device="cpu")
    p, o, zero = shd.shard_train_state(plan, p, opt_init(oc, p), c)
    step = make_train_step(c, oc, StepConfig(microbatches=k), plan=plan,
                           zero=zero)
    out = {"elems": sum(x.numel() for x in tree.leaves(p)),
           "opt_elems": sum(x.numel() for x in tree.leaves(o)),
           "metrics": []}
    for i, bt in enumerate(batches):
        batch = {key: torch.from_numpy(v) for key, v in bt.items()}
        if i == 0 and grads_of_first:
            g, _ce, _aux = step.grads(p, batch)
            if oc.name == "adamw":
                g = zero.gather_tree(g)
            out["grads"] = _np_leaves(zero.unshard(g))
        p, o, m = step(p, o, batch)
        out["metrics"].append({key: float(v) for key, v in m.items()})
    out["params"] = _np_leaves(zero.unshard(p))
    return out


def one_process_steps(arch: str, kw: dict, params_np, batches: list,
                      opt: dict, k: int = 1) -> dict:
    """The same steps on one process (no plan)."""
    c = sharded_config(arch, kw)
    oc = OptConfig(**{**LM_OPT, **opt})
    p = bridge.params_from_numpy(params_np, device="cpu")
    o = opt_init(oc, p)
    step = make_train_step(c, oc, StepConfig(microbatches=k))
    out = {"metrics": [], "elems": sum(x.numel() for x in tree.leaves(p)),
           "opt_elems": sum(x.numel() for x in tree.leaves(o))}
    for bt in batches:
        batch = {key: torch.from_numpy(v) for key, v in bt.items()}
        p, o, m = step(p, o, batch)
        out["metrics"].append({key: float(v) for key, v in m.items()})
    out["params"] = _np_leaves(p)
    return out


def _np_tree(t):
    """A param tree as numpy (the reference's layout, for ``bridge``)."""
    return tree.tree_map(lambda x: x.detach().numpy().copy(), t)


def sharded_cases(world, cases: list) -> dict:
    """:func:`sharded_steps` for each ``(name, arch, kw, placement,
    params_np, batches, opt, k, force_fsdp, flags)`` in turn, in one
    world."""
    return {name: sharded_steps(world, arch, kw, placement, params_np,
                                batches, opt, k, fsdp, flags=flags)
            for name, arch, kw, placement, params_np, batches, opt, k, fsdp,
            flags in cases}


def vocab_parallel_loss(world) -> dict:
    """The vocabulary-parallel ``next_token_loss`` (tp2: this rank's
    vocabulary columns of seeded logits, labels with masked entries, with
    and without the z-loss) beside the whole-vocabulary loss of the same
    logits, and the gradient of this rank's columns beside the whole
    loss's gradient there."""
    from repro_torch.parallel import layout as layout_mod
    from repro_torch.train.loss import next_token_loss
    c = get_config("gpt-117m").reduced(**F32)
    mesh = make_mesh((1, 2), ("data", "model"))
    lay = layout_mod.Layout(mesh, 2, {})
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn((2, 8, c.padded_vocab), generator=gen) * 3
    labels = torch.randint(0, c.vocab, (2, 8), generator=gen)
    labels[0, :3] = -1
    n = c.padded_vocab // 2
    out = {}
    for key, z in (("ce", 0.0), ("ce_z", 1e-3)):
        whole = logits.clone().requires_grad_(True)
        w = next_token_loss(c, whole, labels, z_coef=z)
        part = logits[..., world.rank * n:(world.rank + 1) * n].clone()
        part.requires_grad_(True)
        with layout_mod.use(lay):
            got = next_token_loss(c, part, labels, z_coef=z)
        out[key], out[key + "_whole"] = float(got.detach()), float(w.detach())
        if z:
            (gw,) = torch.autograd.grad(w, whole)
            (gp,) = torch.autograd.grad(got, part)
            out["grad"] = gp.numpy()
            out["grad_whole"] = gw[..., world.rank * n:
                                   (world.rank + 1) * n].numpy()
    return out


def sharded_checkpoint(world, ckpt_dir: str, placement: str,
                       write: bool) -> dict:
    """Two dp2tp2 steps of reduced gpt-117m written to ``ckpt_dir`` by the
    train loop (``write``), or the latest checkpoint restored into
    ``placement``'s layout; the whole params either way, and the loss of
    one more step from the restored state."""
    from repro_torch.launch.train import make_data_fn
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.ckpt.checkpoint import restore
    from repro_torch.models import lm
    c = lm_config()
    oc = OptConfig(**LM_OPT)
    p = lm.init(c, torch.Generator().manual_seed(0), "cpu")
    o = opt_init(oc, p)
    if placement == "dp1":
        step = make_train_step(c, oc, StepConfig())
        dp = None
    else:
        plan = shd.make_plan(c, mesh_for(Placement.of(placement)),
                             ShapeConfig("t", 32, 8, "train"))
        p, o, zero = shd.shard_train_state(plan, p, o, c)
        step = make_train_step(c, oc, StepConfig(), plan=plan, zero=zero)
        dp = shd.DpCheckpoint(zero)
    data = make_data_fn(c, 8, 32, 0, "cpu")
    out = {}
    if write:
        cfg = LoopConfig(total_steps=2, ckpt_every=1, ckpt_dir=ckpt_dir,
                         log_every=0, seq_len=32, global_batch=8)
        res = train_loop(step, p, o, data, cfg, dp=dp)
        out["step"] = len(res.losses)
        (p, o), _ = restore((p, o), ckpt_dir, dp=dp)
    else:
        (p, o), man = restore((p, o), ckpt_dir, dp=dp)
        out["step"] = man["step"]
    out["whole"] = _np_leaves(p if dp is None else dp.zero.unshard(p))
    p, o, m = step(p, o, data(2))
    out["next_loss"] = float(m["loss"])
    return out


def _cache_dict(caches) -> dict:
    """``{"slot/leaf": array}`` of a cache tree."""
    return {f"{slot}/{key}": v.detach().numpy().copy()
            for slot, leaves in caches.items() for key, v in leaves.items()}


def sharded_serve(world, cases: list) -> dict:
    """For each ``(name, arch, kw, placement, ref)``: the reference's
    weights, prompt ``toks``, next token ``nxt`` and the slotted cache of
    ``t`` positions its prefill filled (``ref``), that cache cut to this
    rank's share (``cache_spec``), one decode step under the plan's layout
    (heads, head dim, SSM heads over ``model``; a batch below the data
    axis cuts the sequence instead), its logits gathered over the
    vocabulary beside the one-process decode's; and the plan's prefill of
    the prompt, its caches beside the cut of the one-process caches."""
    from repro_torch.launch.specs import _cut, local_rows
    from repro_torch.models import lm
    from repro_torch.parallel import layout as layout_mod
    from repro_torch.train.step import batch_axes
    out = {}
    for name, arch, kw, placement, ref in cases:
        c = sharded_config(arch, kw)
        params = bridge.params_from_numpy(ref["params"], "cpu")
        toks = torch.from_numpy(ref["toks"]).long()
        nxt = torch.from_numpy(ref["nxt"]).long()
        (b, n_pre), t = toks.shape, ref["t"]
        whole = bridge.params_from_numpy(ref["caches"], "cpu")
        with torch.no_grad():
            _l, pre, _e = lm.prefill(c, params, toks)
            want, _ = lm.decode_step(
                c, params, nxt, tree.tree_map(torch.Tensor.clone, whole),
                n_pre)
        plan = shd.make_plan(c, mesh_for(Placement.of(placement)),
                             ShapeConfig("d", t, b, "decode"))
        zero = shd.Zero1(plan, params, c)
        axes = batch_axes(plan, b)
        seq = plan.seq_axis if not axes else None
        lay = zero.layout(axes, seq)
        rows = local_rows(plan, b)
        r0 = plan.mesh.index(axes) * rows if axes else 0
        mine = {slot: {key: _cut(v, shd.cache_spec(c, plan, (slot, key),
                                                   tuple(v.shape)),
                                 plan.mesh)
                       for key, v in leaves.items()}
                for slot, leaves in whole.items()}
        p = zero.shard(params)
        with torch.no_grad(), layout_mod.use(lay):
            got, _ = lm.decode_step(c, p, nxt[r0:r0 + rows], mine, n_pre)
            _pl, pcache, _pe = lm.prefill(c, p, toks[r0:r0 + rows])
        if got.shape[-1] < c.padded_vocab:
            got = plan.mesh.all_gather(got, "model", 2)
        # a prefill cuts no sequence (only a long-context decode does)
        pplan = shd.make_plan(c, plan.mesh, ShapeConfig("p", t, b, "prefill"))
        cut_pre = {slot: {key: _cut(v, shd.cache_spec(
            c, pplan, (slot, key), tuple(v.shape)), plan.mesh)
            for key, v in leaves.items()} for slot, leaves in pre.items()}
        out[name] = {
            "rank": world.rank, "rows": (r0, r0 + rows),
            "logits": got.numpy(), "want": want[r0:r0 + rows].numpy(),
            "prefill_caches": _cache_dict(pcache),
            "want_caches": _cache_dict(cut_pre)}
    return out


def real_rank_flops(world, arch: str, kw: dict, placement: str, gb: int,
                    seq: int, k: int) -> dict:
    """The matmul FLOPs (``FlopCounterMode``) of one plan step on this
    rank's CPU ranks, the dry run's step: ``k`` microbatches, full remat,
    the plan's attention formulation, AdamW; and the mesh's
    ``reduce_scatter`` beside an all-reduce and a narrow done by hand."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import lm
    c = sharded_config(arch, kw)
    mesh = mesh_for(Placement.of(placement))
    plan = shd.make_plan(c, mesh, ShapeConfig("t", seq, gb, "train"))
    params = lm.init(c, torch.Generator().manual_seed(0), "cpu")
    oc = OptConfig()
    p, o, zero = shd.shard_train_state(plan, params, opt_init(oc, params), c)
    step = make_train_step(c, oc, StepConfig(microbatches=k, remat="full",
                                             impl=plan.attn_impl),
                           plan=plan, zero=zero)
    toks = torch.randint(0, c.vocab, (gb, seq),
                         generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as fc:
        step(p, o, {"tokens": toks, "labels": torch.roll(toks, -1, 1)})
    x = torch.arange(8.0) * (world.rank + 1)
    rs = mesh.reduce_scatter(x.reshape(2, 4), "model", 0)
    by_hand = mesh.all_reduce(x.reshape(2, 4), "model")[mesh.index(
        "model"):mesh.index("model") + 1]
    return {"flops": float(fc.get_total_flops()),
            "reduce_scatter_ok": bool(torch.equal(rs, by_hand)),
            "backend": mesh.backend}


def layout_collectives(world) -> dict:
    """On a (data 2, model 2) mesh of four ranks: ``Mesh.all_to_all`` over
    ``model`` (two ranks) and over both axes (four) on seeded blocks, and
    the gradients of the layout's sequence-parallel brackets and MoE
    all-to-all on a small sublayer, beside the whole tensors' ``autograd``
    on this rank (the test holds them against each other and a numpy
    permutation)."""
    from repro_torch.parallel import layout as layout_mod
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {"rank": world.rank, "model": mesh.index("model"),
           "both": mesh.index(("data", "model"))}
    # blocks (8, 6) of this rank's numbers, split on dim 0 / joined on 1
    blk = torch.arange(48, dtype=torch.float32).reshape(8, 6) \
        + 100 * world.rank
    out["a2a_model"] = mesh.all_to_all(blk, "model", 0, 1).numpy()
    out["a2a_both"] = mesh.all_to_all(blk, ("data", "model"), 0, 1).numpy()
    # a sublayer under sequence parallelism, and its whole twin
    gen = torch.Generator().manual_seed(7 + mesh.index("data"))
    B, S, D, F = 2, 8, 4, 6
    X, G = torch.randn(B, S, D, generator=gen), torch.randn(B, S, D,
                                                            generator=gen)
    A, Bw = torch.randn(D, F, generator=gen), torch.randn(F, D,
                                                          generator=gen)
    M, M2 = torch.randn(D, F, generator=gen), torch.randn(D, D,
                                                          generator=gen)
    scale = torch.randn(D, generator=gen)

    def model(x, a, b, m, m2, sc, lay):
        """cut -> scale on the rows -> split sublayer (a whole consumer
        of its input inside) -> whole sublayer -> gather -> loss."""
        if lay is not None:
            x = lay.cut(x, 1)
            sc = lay.on_rows(sc)
        h = x * sc
        if lay is not None:
            xc, xw = lay.enter(h)
            mw = lay.local(lay.col(xw @ m), -1)
        else:
            xc, mw = h, h @ m
        o = ((xc @ a) * mw) @ b
        x = x + (lay.exit(o) if lay is not None else o)
        w = x if lay is None else lay.whole_in(x)
        w = w @ m2
        x = x + (w if lay is None else lay.whole_out(w))
        if lay is not None:
            x = lay.gather_whole(x, 1)
        return (x * G).sum()

    leaves = [t.clone().requires_grad_(True) for t in (X, A, Bw, M, M2,
                                                       scale)]
    whole = torch.autograd.grad(model(*leaves, None), leaves)
    r, n = mesh.index("model"), F // 2
    mine = [X.clone(), A[:, r * n:(r + 1) * n].clone(),
            Bw[r * n:(r + 1) * n].clone(), M.clone(), M2.clone(),
            scale.clone()]
    mine = [t.requires_grad_(True) for t in mine]
    lay = layout_mod.Layout(mesh, 2, {}, seq_axis="model")
    got = torch.autograd.grad(model(*mine, lay), mine)
    want = [whole[0], whole[1][:, r * n:(r + 1) * n],
            whole[2][r * n:(r + 1) * n], *whole[3:]]
    out["sp_grads"] = [(g.numpy(), w.numpy()) for g, w in zip(got, want)]
    # the MoE buffer's all-to-all and back: identity, and its gradient
    t = torch.randn(4, 3, 2, generator=gen).requires_grad_(True)
    y = lay.all_to_all(t, 0, 2)
    back = lay.all_to_all(y, 2, 0)
    (gy,) = torch.autograd.grad((y * torch.arange(
        float(y.numel())).reshape(y.shape)).sum(), t)
    out["a2a_roundtrip"] = bool(torch.equal(back, t))
    out["a2a_shape"] = tuple(y.shape)
    out["a2a_grad"] = gy.numpy()
    out["a2a_in"] = t.detach().numpy()
    return out


# ---------------------------------------------------------------------------
# The training launcher's rank worlds
# ---------------------------------------------------------------------------


def launcher_runs(world, runs: list) -> dict:
    """``launch.train.run`` of each ``(key, argv)`` in turn in one world:
    each run's losses, resume step, final step and, under a fault
    schedule, the supervisor's restarts, fallbacks, wasted steps and
    resume steps."""
    from repro_torch.launch import train as train_cli
    out = {}
    for key, argv in runs:
        res = train_cli.run(train_cli.parse_args(argv), world)
        sup = res.supervisor
        out[key] = {"losses": res.losses, "resumed_from": res.resumed_from,
                    "final_step": res.final_step,
                    "restarts": sup.restarts if sup else 0,
                    "ckpt_fallbacks": sup.ckpt_fallbacks if sup else 0,
                    "wasted_steps": sup.wasted_steps if sup else 0,
                    "resume_steps": sup.resume_steps if sup else []}
    return out


def launcher_and_plan(world, runs: list, cases: list) -> dict:
    """:func:`launcher_runs` and :func:`sharded_cases` in one world."""
    return {"runs": launcher_runs(world, runs),
            "plan": sharded_cases(world, cases)}
