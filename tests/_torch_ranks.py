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
