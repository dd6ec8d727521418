"""Paper Fig. 4 analog: throughput heatmap over (data-parallel degree x
global batch size), with infeasible cells excluded by constraints (the
report renders them as OOM, like the paper's figure).

Port of ``src/repro/bench/workloads/heatmap.py``: the reference's Space
(``placement`` dp1..dp8 x ``global_batch`` 8/16/32 x ``micro_batch`` 1
with the paper's "global batch not divisible by micro_batch x dp" and
"global batch >= dp" exclusions), smoke preset, tags, result columns,
primary metric and ``heatmap_keys``, its ``SEQ`` and its optimizer and
step configs. Each cell trains the GPT decoder with
``train.step.make_train_step`` on one synthetic batch that repeats every
step and records tokens/s and ms a step; the runner stamps
``tok_s_per_device`` and ``scaling_efficiency`` against the dp1 column.

What differs from the reference:

  * **Placement.** A dpN column runs in N ranks (``launch.mesh``)
    under ``make_dp_plan``: each rank trains on its rows of the global
    batch, the gradients are all-reduced to their mean (the reference's
    GSPMD step computes the global mean) and AdamW's state is cut to
    ZeRO-1 slices. A column the process cannot place (dp2 and wider on
    one card) is ``deferred`` with its sbatch script.
  * **Model scale.** On the CPU a cell trains the reference's reduced
    gpt-117m (2 layers, d_model 128, vocab 2048), so its records can be
    held against the reference's; on a card, full-width, full-depth
    gpt-117m (12 layers, d_model 768, vocab 50257; bf16 compute, fp32
    master weights and moments, full remat), from seeded random
    weights. Every record says which (``model_scale``) and carries
    ``n_params``.
  * **State.** The base state is built once from a ``torch.Generator``
    seeded with 0. The step updates its state in place (the reference
    donates it), so each cell trains its own copy.
  * **Window.** On a card the measured steps span at least
    ``MIN_WINDOW_S``, so that NVML's energy counter, which updates about
    every 100 ms, resolves the window: the count comes from a timed
    probe step, and a window that still falls short (the step times
    vary) is measured again with twice the steps.
  * **Extra columns.** ``tokens_per_wh`` (tokens of a step over
    ``energy_wh``, the Wh of a step), ``loss_first`` /
    ``loss_last`` of the first and last measured step (the batch
    repeats, so the loss falls), ``iters``, and on a card
    ``peak_mem_gb`` (``torch.cuda.max_memory_allocated`` over the cell)
    and ``mfu``: 6 N FLOP a token (N parameters; attention's
    sequence-squared terms left out) over the step time against the
    card's dense bf16 peak (``core.metrics.mfu``).
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.bench.spec import Placement, workload
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.core.metrics import mfu, tokens_per_s
from repro_torch.core.params import Space
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.parallel import sharding as shd
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import (StepConfig, init_train_state,
                                    make_train_step)

SEQ = 64
SEED = 0
#: least wall time of a measured window on a card, seconds
MIN_WINDOW_S = 0.5


def _dp(pt) -> int:
    return Placement.of(pt["placement"]).n_devices


def config(device: torch.device):
    """``(config, model_scale)``: the reference's reduced gpt-117m on the
    CPU, the full one on a card."""
    c = get_config("gpt-117m")
    if device.type == "cpu":
        return c.reduced(n_layers=2, d_model=128, d_ff=256, n_heads=4,
                         n_kv_heads=4, d_head=32, vocab=2048), "reduced"
    return c, "full"


def _setup(ctx):
    """``(config, opt config, params, opt_state, model_scale, n_params)``
    on the run's device, built once."""
    def make():
        c, scale = config(ctx.device)
        oc = OptConfig(warmup=1, total_steps=100)
        gen = torch.Generator(device=ctx.device).manual_seed(SEED)
        params, opt_state = init_train_state(c, oc, gen, ctx.device)
        n_params = sum(p.numel() for p in tree.leaves(params))
        return c, oc, params, opt_state, scale, n_params

    return ctx.memo("heatmap", make)


def _dp_step(ctx, c, oc, params, placement: Placement):
    """The placement's step and ZeRO-1 layout, once per placement."""
    def make():
        plan = shd.make_dp_plan(ctx.mesh(placement))
        zero = shd.Zero1(plan, params)
        return make_train_step(c, oc, StepConfig(), plan=plan,
                               zero=zero), zero

    return ctx.memo(("heatmap_dp", placement.label), make)


@workload(
    "heatmap",
    analog="Fig. 4 (dp x global-batch throughput heatmap)",
    space=Space({"placement": ["dp1", "dp2", "dp4", "dp8"],
                 "global_batch": [8, 16, 32],
                 "micro_batch": [1]},
                [lambda pt: pt["global_batch"] % (pt["micro_batch"]
                                                  * _dp(pt)) == 0,
                 lambda pt: pt["global_batch"] >= _dp(pt)]),
    smoke={"placement": ["dp1", "dp2"], "global_batch": [8]},
    tags=("train", "smoke", "full"),
    result_columns=["placement", "global_batch", "tokens_per_s",
                    "tok_s_per_device", "scaling_efficiency", "ms",
                    "power_source"],
    primary_metric="tokens_per_s",
    heatmap_keys=("placement", "global_batch", "tokens_per_s"),
)
def build(pt, ctx):
    """dp x batch train-step sweep (paper Fig. 4)."""
    c, oc, params, opt_state, scale, n_params = _setup(ctx)
    step, zero = _dp_step(ctx, c, oc, params, Placement.of(pt["placement"]))
    gb = pt["global_batch"]
    toks = torch.from_numpy(synthetic_tokens(gb, SEQ, c.vocab)[:, :SEQ])
    toks = toks.to(ctx.device)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    cuda = ctx.device.type == "cuda"

    def run():
        # the step updates its state in place, and the base state is
        # memoized across cells and retries: each cell trains a copy
        p = tree.tree_map(torch.Tensor.clone, params)
        o = shd.shard_opt_state(zero, opt_state)
        losses = []

        def one():
            nonlocal p, o
            p, o, m = step(p, o, batch)
            losses.append(m["loss"])
            return m["loss"]

        iters = None
        if cuda:
            torch.cuda.reset_peak_memory_stats(ctx.device)
            one()
            ctx.sync()
            t0 = time.perf_counter()
            one()
            ctx.sync()
            probe = time.perf_counter() - t0
            iters = max(ctx.iters, math.ceil(MIN_WINDOW_S / max(probe, 1e-6)))
        m = ctx.measure(one, iters=iters)
        while cuda and m.seconds * m.iters < MIN_WINDOW_S:
            m = ctx.measure(one, iters=2 * m.iters)
        measured = [float(x) for x in losses[-m.iters:]]
        out = {"tokens_per_s": tokens_per_s(gb, SEQ, m.seconds),
               "ms": m.ms, "seconds": m.seconds,
               "energy_wh": m.energy_wh,
               "tokens_per_wh": (gb * SEQ / m.energy_wh)
               if m.energy_wh > 0 else 0.0,
               "loss_first": measured[0], "loss_last": measured[-1],
               "iters": m.iters, "model_scale": scale, "n_params": n_params}
        if cuda:
            out["peak_mem_gb"] = (torch.cuda.max_memory_allocated(ctx.device)
                                  / 1e9)
            out["mfu"] = mfu(6 * n_params * gb * SEQ, m.seconds,
                             zero.mesh.size)
        return out

    return {"run": run}
