"""Training CLI: the end-to-end entry point.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-117m \
      --preset tiny --steps 50 --ckpt-dir /tmp/ckpt --device cpu

Port of ``src/repro/launch/train.py`` (``make_data_iter``, the
``ShardedLoader`` path, and the step-indexed ``make_data_fn``, which
give the same batches, for every model family, with a vlm's patch and
an encdec's frame inputs; and ``main`` with its flags). ``--device``
defaults to the CUDA card and raises without one; ``--preset full``
trains the full-width config (on the card: bf16 compute, fp32 master
weights). A multi-device ``--placement`` (``dp2``, ``tp2``, ``dp2tp2``,
``pp2``, ...) trains in that many ranks (``launch.mesh``): joined from
the environment when a launcher started them (``WORLD_SIZE`` set, as
``launch/slurm.py``'s scripts do), else spawned here (gloo processes on
the CPU; NCCL ranks, one a card, on cards). Each rank holds its shards
of the params under the placement's plan (the reference's rule table:
heads, FFN columns, experts and vocabulary over ``tp``, FSDP for the
largest archs) and the ZeRO-1 slices of their optimizer state, and
trains its part of the global step (``train.step``); rank 0 prints and
writes the checkpoints, whole leaves gathered from every rank
(``CheckpointManager(dp=...)``).

A pipeline placement (``pp2``, ``dp2pp2``, ``pp2tp2``) trains as the
reference's launcher trains it: as data parallelism over the ``stage``
axis (``launch.mesh.dp_axes`` counts every axis but ``model``), each
rank holding whole layers, its rows of the global batch cut over
``data`` and ``stage`` together, gradients all-reduced over the group of
those axes. The pipeline schedule itself runs in the ``pipeline_gpt``
workload (``parallel.pipeline``); this launcher has none.

A fault schedule (``--fault-preset``) runs through the bounded-restart
supervisor on every rank of the world: each rank raises at the same
scheduled step, the ranks meet, rank 0 resolves the resume step from
the checkpoint directory and every rank resumes there. A device loss
restarts at the same world size, as the reference's launcher does (it
passes no elastic ``on_device_loss``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io

import numpy as np
import torch

from repro_torch.bench.spec import Placement
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import tree
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.faults.schedule import TRAIN_PRESETS, FaultSchedule
from repro_torch.faults.supervisor import run_supervised
from repro_torch.launch import mesh as mesh_mod
from repro_torch.parallel import sharding as shd
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import (StepConfig, init_train_state,
                                    make_train_step)


def _side_inputs(c, global_batch: int, dev: torch.device) -> dict:
    """A vlm's ``patch_embeds`` (B, n_patches, D) or an encdec's
    ``enc_frames`` (B, enc_seq, D): zeros in bf16, as the reference's."""
    side = {"vlm": ("patch_embeds", c.n_patches),
            "encdec": ("enc_frames", c.enc_seq)}.get(c.family)
    if side is None:
        return {}
    return {side[0]: torch.zeros((global_batch, side[1], c.d_model),
                                 dtype=torch.bfloat16, device=dev)}


def make_data_iter(c, global_batch: int, seq_len: int, seed: int = 0,
                   device: DeviceLike = None):
    """The loader form: a generator of batches through a
    ``ShardedLoader`` (rank 0 of 1) over the reference's samples, row
    ``i % 4096`` of a seeded ``synthetic_tokens`` table, tokens
    ``row[:-1]``, labels ``row[1:]``, plus :func:`_side_inputs`. The
    loader's thread builds numpy batches; this generator moves each to
    ``device`` and closes the loader when it is closed or collected."""
    dev = resolve_device(device)
    toks = synthetic_tokens(4096, seq_len, c.vocab, seed=seed)

    def sample(idx: int):
        row = toks[idx % toks.shape[0]]
        return {"tokens": row[:-1], "labels": row[1:]}

    loader = ShardedLoader(sample, global_batch)

    def gen():
        try:
            for batch in loader:
                out = {k: torch.from_numpy(batch[k]).to(dev)
                       for k in ("tokens", "labels")}
                out.update(_side_inputs(c, global_batch, dev))
                yield out
        finally:
            loader.close()

    return gen()


def make_data_fn(c, global_batch: int, seq_len: int, seed: int = 0,
                 device: DeviceLike = None):
    """Step-indexed data: ``data(step) -> batch``, the resume-safe form.

    A fresh iterator restarts at sample 0 after a crash, silently
    desyncing the data stream from the checkpointed step counter —
    indexing by step keeps batch ``N`` identical whether the run reached
    step ``N`` directly or through three crash/resume cycles, which is
    what makes the resumed loss trace bit-equal to the uninterrupted
    one. Same sample indexing as :func:`make_data_iter` (rank 0 of 1),
    so the two forms produce identical batches at every step.
    """
    dev = resolve_device(device)
    toks = synthetic_tokens(4096, seq_len, c.vocab, seed=seed)

    def data(step: int):
        idx = (step * global_batch + np.arange(global_batch)) % toks.shape[0]
        rows = torch.from_numpy(toks[idx])
        out = {"tokens": rows[:, :-1].to(dev), "labels": rows[:, 1:].to(dev)}
        out.update(_side_inputs(c, global_batch, dev))
        return out

    return data


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-117m")
    ap.add_argument("--preset", choices=["full", "tiny"], default="tiny",
                    help="tiny = reduced config for CPU end-to-end runs")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a failure (fault-tolerance demo)")
    ap.add_argument("--fault-preset", default=None, choices=TRAIN_PRESETS,
                    help="seeded fault schedule; the run goes through the "
                         "bounded-restart supervisor (faults.supervisor)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--placement", default="dp1",
                    help="device mesh, e.g. dp4 or dp2tp2 — the same "
                         "Placement spelling the bench sweeps use")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def _train_rank(world, argv):
    """One rank of a spawned dp world: rank 0 returns the result."""
    res = run(parse_args(argv), world)
    return res if world.rank == 0 else None


def main(argv=None):
    args = parse_args(argv)
    placement = Placement.of(args.placement)
    n = placement.n_devices
    if n == 1:
        return run(args)
    env_n = mesh_mod.env_world_size()
    if env_n > 1:
        if env_n != n:
            raise SystemExit(f"error: placement {placement.label} needs {n} "
                             f"ranks, the world has {env_n}")
        return run(args, mesh_mod.init_world(args.device))
    return mesh_mod.spawn(_train_rank, n, args=(argv,),
                          device=args.device)[0]


def run(args, world=None):
    """Train as the flags say: on one device, or as a rank of ``world``
    under the placement's plan."""
    placement = Placement.of(args.placement)
    dev = world.device if world is not None else resolve_device(args.device)
    c = get_config(args.arch)
    if args.preset == "tiny":
        c = c.reduced()
    oc = OptConfig(lr=args.lr, warmup=max(args.steps // 20, 5),
                   total_steps=args.steps)
    sc = StepConfig(microbatches=args.microbatches)

    # state is rebuilt per supervisor attempt (the step updates it in
    # place, so a crashed attempt's state cannot be reused), then the
    # loop's auto-resume overwrites it from the checkpoint
    def fresh_state():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return init_train_state(c, oc, gen, dev)

    params, opt_state = fresh_state()
    n_params = sum(p.numel() for p in tree.leaves(params))
    init_state, dp, quiet = fresh_state, None, False
    if world is None:
        step = make_train_step(c, oc, sc)
    else:
        plan = shd.make_plan(c, mesh_mod.mesh_for(placement),
                             ShapeConfig("train_cli", args.seq_len,
                                         args.global_batch, "train"))
        params, opt_state, zero = shd.shard_train_state(plan, params,
                                                        opt_state, c)
        step = make_train_step(c, oc, sc, plan=plan, zero=zero)
        dp = shd.DpCheckpoint(zero)
        quiet = world.rank != 0

        def init_state():
            p, o = fresh_state()
            return zero.shard(p), shd.shard_opt_state(zero, o)

    with contextlib.redirect_stdout(io.StringIO()) if quiet \
            else contextlib.nullcontext():
        return _train(args, c, placement, dev, step, params, opt_state,
                      init_state, dp, n_params)


def _train(args, c, placement, dev, step, params, opt_state, init_state,
           dp, n_params):
    print(f"[train] arch={c.name} params={n_params / 1e6:.1f}M "
          f"batch={args.global_batch} seq={args.seq_len} "
          f"placement={placement.label} device={dev}")
    data = make_data_fn(c, args.global_batch, args.seq_len, args.seed, dev)
    cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, log_every=10,
                     seq_len=args.seq_len, global_batch=args.global_batch)
    if args.fault_preset and args.fault_preset != "none":
        faults = FaultSchedule.from_preset(args.fault_preset,
                                           args.fault_seed, args.steps)
        print(f"[train] fault schedule {faults!r}")

        def run_once(hook):
            p, o = init_state()
            return train_loop(step, p, o, data, cfg, hooks=[hook],
                              faults=faults, dp=dp)

        sup = run_supervised(run_once, ckpt_dir=args.ckpt_dir,
                             max_restarts=args.max_restarts,
                             seed=args.fault_seed, world=dp)
        res = dataclasses.replace(sup.result, supervisor=sup)
        print(f"[train] supervised: restarts={sup.restarts} "
              f"wasted_steps={sup.wasted_steps} "
              f"recovery_s={sup.recovery_s:.3f} "
              f"backoff_s={sup.backoff_s:.3f} "
              f"ckpt_fallbacks={sup.ckpt_fallbacks}")
    else:
        res = train_loop(step, params, opt_state, data, cfg,
                         fail_at_step=args.fail_at_step, dp=dp)
    print(f"[train] done: steps={res.steps_run} "
          f"first_loss={res.losses[0]:.4f} last_loss={res.losses[-1]:.4f} "
          f"tokens/s={res.tokens_per_s:,.0f} resumed_from={res.resumed_from}")
    return res


if __name__ == "__main__":
    main()
