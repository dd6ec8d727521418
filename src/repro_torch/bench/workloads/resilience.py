"""Resilience sweep: what fault tolerance costs in time and energy.

Port of ``src/repro/bench/workloads/resilience.py``: the reference's
Space, smoke preset, result columns, primary metric and compare
tolerances, and its constants (``TOTAL_STEPS``, ``GLOBAL_BATCH``,
``SEQ``, the fault seed). Each cell runs the crash → backoff → resume
machinery (``faults.schedule`` + ``faults.supervisor`` + the training
loop's auto-resume through ``ckpt``) end to end under a seeded fault
schedule, against the checkpoint cadence axis of the Young/Daly
tradeoff, and records

  recovery_s               crash -> first completed resumed step
  wasted_tokens            recomputed steps x tokens/step
  goodput_tokens_per_s     delivered tokens / end-to-end wall including
                           crashes, backoff, and recompute
  wh_overhead_resilience   cell energy minus the fault-free, ckpt-free
                           twin of the same arch

plus ``twin_wall_s`` (the twin's wall, 30 steps without checkpoints or
faults; the port adds it) and ``loss_bitmatch``: the resumed run's loss
trace must equal the port's own uninterrupted twin's at every
overlapping step, element for element (resume restored the real state;
step-indexed data kept the stream aligned). ``schedule_hash`` stamps the
cell's fault schedule; the same ``(preset, seed)`` gives the reference's
hash.

Model scale, as in the other port workloads: the reference's reduced
gpt-117m on the CPU, full-width gpt-117m (bf16, fp32 master weights) on
a card, with the reference's steps, batch, sequence and fault seed at
both; ``model_scale`` and ``n_params`` say which. A full-width
checkpoint of params and AdamW state is ~1.7 GB.
"""
from __future__ import annotations

import shutil
import tempfile
import time

import torch

from repro_torch.bench.spec import workload
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.core.params import Space
from repro_torch.faults.schedule import FaultSchedule
from repro_torch.faults.supervisor import run_supervised
from repro_torch.launch.train import make_data_fn
from repro_torch.power.ctxmgr import get_power
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import (StepConfig, init_train_state,
                                    make_train_step)

TOTAL_STEPS = 30
GLOBAL_BATCH = 4
SEQ = 32
FAULT_SEED = 0
MAX_RESTARTS = 5


def setup(ctx, arch: str):
    """Config, step (warmed), step-indexed data, fresh-state factory,
    model scale and parameter count — shared by every cell and by the
    fault-free twin, so the loss traces being compared ran the same
    step."""

    def make():
        c, scale = get_config(arch), "full"
        if ctx.device.type == "cpu":
            c = c.reduced(d_model=64, n_layers=2, d_ff=256, vocab=512,
                          n_heads=4, n_kv_heads=4, d_head=16)
            scale = "reduced"
        oc = OptConfig(warmup=2, total_steps=TOTAL_STEPS)
        step = make_train_step(c, oc, StepConfig(microbatches=1))
        data = make_data_fn(c, GLOBAL_BATCH, SEQ, seed=0, device=ctx.device)

        def init_state():
            gen = torch.Generator(device=ctx.device).manual_seed(0)
            return init_train_state(c, oc, gen, ctx.device)

        # first calls (library handles, allocator pools) stay outside
        # any timed window — otherwise the twin (which runs first) pays
        # them and the "overhead of resilience" goes negative
        p, o = init_state()
        float(step(p, o, data(0))[2]["loss"])
        n_params = sum(x.numel() for x in tree.leaves(p))
        return c, step, data, init_state, scale, n_params

    return ctx.memo(("resilience", arch), make)


def _twin(ctx, arch: str):
    """The fault-free, checkpoint-free twin: same arch, same seed, same
    step, no faults, no ckpt I/O. Its wall/energy is the baseline the
    resilience overhead is measured against; its loss trace is the
    bit-equality reference."""

    def make():
        _, step, data, init_state, _, _ = setup(ctx, arch)
        cfg = LoopConfig(total_steps=TOTAL_STEPS, ckpt_every=10 ** 9,
                         ckpt_dir=None, log_every=0,
                         seq_len=SEQ, global_batch=GLOBAL_BATCH)
        p, o = init_state()
        with get_power(ctx.power_methods, ctx.power_interval_ms) as scope:
            t0 = time.perf_counter()
            res = train_loop(step, p, o, data, cfg)
            wall = time.perf_counter() - t0
        return {"wall_s": wall, "energy_wh": scope.total_energy_wh(),
                "losses": list(res.losses)}

    return ctx.memo(("resilience_twin", arch), make)


@workload(
    "resilience",
    analog="fault-tolerance cost: recovery time + energy vs ckpt cadence",
    space=Space({"arch": ["gpt-117m"],
                 "fault_preset": ["none", "crash_mid", "ckpt_corrupt"],
                 "ckpt_every": [5, 10, 20]}),
    smoke={"fault_preset": ["none", "crash_mid"], "ckpt_every": [10]},
    tags=("train", "smoke", "full"),
    result_columns=["arch", "fault_preset", "ckpt_every", "final_step",
                    "restarts", "recovery_s", "wasted_tokens",
                    "goodput_tokens_per_s", "wh_overhead_resilience",
                    "loss_bitmatch", "ckpt_fallbacks", "schedule_hash",
                    "power_source"],
    primary_metric="goodput_tokens_per_s",
    compare_tols={"recovery_s": 1.5, "wh_overhead_resilience": 3.0,
                  "goodput_tokens_per_s": 0.4, "final_loss": 0.05},
)
def build(pt, ctx):
    """One supervised crash/resume run per (fault_preset, ckpt_every)."""
    arch, preset = pt["arch"], pt["fault_preset"]
    ckpt_every = int(pt["ckpt_every"])
    _, step, data, init_state, scale, n_params = setup(ctx, arch)
    twin = _twin(ctx, arch)
    tokens_per_step = GLOBAL_BATCH * SEQ

    def run():
        # fresh schedule per attempt-set: `fired` is shared across the
        # supervisor's restarts of ONE run, not across runner retries
        faults = FaultSchedule.from_preset(preset, FAULT_SEED, TOTAL_STEPS)
        ckpt_dir = tempfile.mkdtemp(prefix=f"resil_{preset}_{ckpt_every}_")
        cfg = LoopConfig(total_steps=TOTAL_STEPS, ckpt_every=ckpt_every,
                         ckpt_dir=ckpt_dir, log_every=0,
                         seq_len=SEQ, global_batch=GLOBAL_BATCH)

        def run_once(hook):
            p, o = init_state()   # the step updated the last ones in place
            return train_loop(step, p, o, data, cfg, hooks=[hook],
                              faults=faults)

        try:
            with get_power(ctx.power_methods,
                           ctx.power_interval_ms) as scope:
                t0 = time.perf_counter()
                sup = run_supervised(run_once, ckpt_dir=ckpt_dir,
                                     max_restarts=MAX_RESTARTS,
                                     seed=FAULT_SEED)
                wall = time.perf_counter() - t0
            energy_wh = scope.total_energy_wh()
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

        res = sup.result
        # the final attempt's losses cover resumed_from..total; the twin
        # ran the same steps uninterrupted — element-exact or the resume
        # restored the wrong state / desynced the data stream
        tail = twin["losses"][len(twin["losses"]) - len(res.losses):]
        bitmatch = (len(res.losses) > 0 and len(tail) == len(res.losses)
                    and all(a == b for a, b in zip(tail, res.losses)))
        delivered = res.final_step * tokens_per_step
        return {
            "final_step": res.final_step,
            "final_loss": res.losses[-1] if res.losses else float("nan"),
            "loss_bitmatch": 1.0 if bitmatch else 0.0,
            "restarts": sup.restarts,
            "recovery_s": round(sup.recovery_s, 6),
            "backoff_s": round(sup.backoff_s, 6),
            "wasted_tokens": sup.wasted_steps * tokens_per_step,
            "tokens_per_step": tokens_per_step,
            "goodput_tokens_per_s": delivered / max(wall, 1e-9),
            "energy_wh": energy_wh,
            "wh_overhead_resilience": energy_wh - twin["energy_wh"],
            "twin_wall_s": twin["wall_s"],
            "ckpt_fallbacks": sup.ckpt_fallbacks,
            "rescales": sup.rescales,
            "schedule_hash": faults.schedule_hash,
            "model_scale": scale,
            "n_params": n_params,
        }

    return {"run": run}
