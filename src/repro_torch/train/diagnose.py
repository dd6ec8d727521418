"""dp train-step diagnosis: attribute multi-device scaling loss.

Port of ``src/repro/train/diagnose.py``. Usage::

  PYTHONPATH=src python -m repro_torch.train.diagnose --placement dp2 \
      --device cpu

Spawns the placement's ranks (``launch.mesh``; gloo on the CPU, NCCL on
cards, one a card) and reports, per step
variant on the reference's reduced gpt-800m, the per-call wall time of
call 0, call 1 (the one a ``warmup=1`` benchmark measures) and the
steady state, and tokens/s. The variants are the bucketed dp step
(``parallel.grad_sync``) with fp32 buckets overlapped with the backward
and not, and with int8 buckets, and a **no-sync** variant: the same
local step with every collective left out (a plan without a dp group),
so a variant's time minus the no-sync time is what gradient
synchronization costs. Its gradients are each rank's own, so its params
drift apart across ranks: it attributes time, it does not train.

What the reference also reports has no analog without XLA and is not
ported: its sharding-drift audit (``audit_shardings``: output leaves
whose layout differs from the placed inputs) and jit-cache size (a
PyTorch step is not traced or cached), and its two GSPMD variants
(``gspmd-unpinned``, ``gspmd-pinned-zero2``: the port has no GSPMD).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.bench.spec import Placement
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import tree
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.launch import mesh as mesh_mod
from repro_torch.parallel import grad_sync as gs
from repro_torch.parallel import sharding as shd
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import StepConfig, init_train_state

VARIANTS = ("bucketed-fp32", "bucketed-fp32-noolap", "bucketed-int8",
            "no-sync")


def time_step(step, args_fn, sync, calls: int = 6) -> list:
    """Per-call wall times of ``step`` from fresh ``args_fn()``."""
    times = []
    args = args_fn()
    for _ in range(calls):
        t0 = time.perf_counter()
        out = step(*args)
        sync()
        times.append(time.perf_counter() - t0)
        args = tuple(out[:len(args) - 1]) + (args[-1],)
    return times


def build_variants(world, placement: str, gb: int, seq: int, k: int):
    """``{label: (step, args_fn)}`` on this rank."""
    c = get_config("gpt-800m").reduced(d_model=128, n_layers=4, d_ff=512,
                                       vocab=8192, n_heads=4, n_kv_heads=4,
                                       d_head=32)
    oc = OptConfig(warmup=2, total_steps=1000)
    dev = world.device
    params, opt_state = init_train_state(
        c, oc, torch.Generator(device=dev).manual_seed(0), dev)
    mesh = mesh_mod.mesh_for(Placement.of(placement))
    plan = shd.make_plan(c, mesh, ShapeConfig("diag", seq, gb, "train"))
    zero = shd.Zero1(plan, params, c)
    toks = torch.from_numpy(synthetic_tokens(gb, seq, c.vocab)[:, :seq])
    toks = toks.to(dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    sc = StepConfig(microbatches=k)

    def fresh(sync):
        def args_fn():
            p = tree.tree_map(torch.Tensor.clone, params)
            o = shd.shard_opt_state(zero, opt_state)
            return p, o, gs.init_sync_state(p, sync), batch
        return args_fn

    variants = {}
    for label, sync in (
            ("bucketed-fp32", gs.GradSyncConfig(mode="fp32")),
            ("bucketed-fp32-noolap", gs.GradSyncConfig(mode="fp32",
                                                       overlap=False)),
            ("bucketed-int8", gs.GradSyncConfig(mode="int8"))):
        variants[label] = (gs.make_dp_train_step(
            c, oc, sc, plan=plan, sync=sync, zero=zero), fresh(sync))
    # the same local step without a dp group: no collective at all; the
    # rank's rows are cut by hand and the optimizer state kept whole
    local = shd.local_batch(plan, batch)
    none_sync = gs.GradSyncConfig(mode="fp32", overlap=False)
    none_step = gs.make_dp_train_step(c, oc, sc, sync=none_sync)

    def none_args():
        p = tree.tree_map(torch.Tensor.clone, params)
        o = tree.tree_map(torch.Tensor.clone, opt_state)
        return p, o, gs.init_sync_state(p, none_sync), local

    variants["no-sync"] = (none_step, none_args)
    return variants


def _rank(world, placement, gb, seq, k, calls):
    rows = []
    sync = (lambda: torch.cuda.synchronize(world.device)) \
        if world.device.type == "cuda" else (lambda: None)
    for label, (step, args_fn) in build_variants(world, placement, gb, seq,
                                                 k).items():
        times = time_step(step, args_fn, sync, calls)
        steady = sum(times[2:]) / max(len(times) - 2, 1)
        rows.append((label, times[0], times[1], steady, gb * seq / steady))
    return rows if world.rank == 0 else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--placement", default="dp2")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--calls", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    n = Placement.of(args.placement).n_devices
    print(f"[diagnose] placement={args.placement} gb={args.global_batch} "
          f"seq={args.seq} mb={args.microbatches} ranks={n} "
          f"device={args.device}")
    rows = mesh_mod.spawn(
        _rank, n, args=(args.placement, args.global_batch, args.seq,
                        args.microbatches, args.calls),
        device=args.device)[0]
    for label, t0, t1, steady, tps in rows:
        print(f"  {label:22s} call0={t0 * 1e3:8.1f}ms "
              f"call1={t1 * 1e3:8.1f}ms steady={steady * 1e3:8.1f}ms "
              f"tok/s={tps:9.1f}")
    by = {r[0]: r for r in rows}
    for label in VARIANTS[:3]:
        print(f"[diagnose] {label}: sync costs "
              f"{(by[label][3] - by['no-sync'][3]) * 1e3:.1f}ms a step "
              f"over no-sync")
    best = min((r for r in rows if r[0] != "no-sync"), key=lambda r: r[3])
    print(f"[diagnose] best steady variant: {best[0]} ({best[4]:.1f} tok/s)")
    return rows


if __name__ == "__main__":
    main()
