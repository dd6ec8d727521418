"""Paper Fig. 2 analog: LLM training throughput + energy vs global batch,
swept across device placements (the CARAML scaling measurement).

Port of ``src/repro/bench/workloads/llm_train.py``: the reference's
Space, smoke preset, result columns, primary metric and microbatch
rule. Each cell trains the paper's GPT decoder with the pure-dp step
(``parallel.grad_sync.make_dp_train_step``, the ``grad_sync`` axis
selecting fp32 or int8 error-feedback buckets, overlap on the card and
off on the CPU, as the reference chooses per backend) and records
tokens/s, ms/step, energy/step and tokens/Wh, CARAML's LLM figures of
merit; the runner stamps ``tok_s_per_device``.

What differs from the reference:

  * **Placement.** A dpN cell runs in N ranks (``launch.mesh``; gloo
    processes on the CPU, one card a rank on cards), each training on
    its rows of the global batch with the plan's dp group reducing the
    buckets and AdamW's state cut to ZeRO-1 slices
    (``parallel.sharding``); the microbatch count comes from the
    per-rank batch, as the reference's. A cell the process cannot place
    (dp2 on one card) is ``deferred`` with its sbatch script.
  * **Model scale.** On the CPU a cell trains the reference's reduced
    config (d_model 128, 4 layers), so its records can be held against
    the reference's; on a card, full-width, full-depth gpt-800m (bf16
    compute and params, fp32 master weights and moments, full remat),
    from seeded random weights. Every record says which
    (``model_scale``) and carries ``n_params``.
  * **State.** The base state is built once per arch from a
    ``torch.Generator`` seeded with 0. The step updates its state in
    place (the reference donates it), so each cell trains its own copy;
    at full width a copy is ~10.5 GB, and only one is alive at a time.
  * **Extra columns.** ``loss_first`` / ``loss_last`` are the losses of
    the first and last measured step (the batch is the same every step,
    so the loss falls), and on a card ``peak_mem_gb`` is
    ``torch.cuda.max_memory_allocated`` over the cell.
"""
from __future__ import annotations

import torch

from repro_torch.bench.spec import Placement, workload
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import tree
from repro_torch.core.metrics import tokens_per_s
from repro_torch.core.params import Space
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.parallel import grad_sync as gs
from repro_torch.parallel import sharding as shd
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import StepConfig, init_train_state

MICROBATCHES = 4
SEED = 0


def _microbatches(gb: int, ndev: int) -> int:
    """Largest microbatch count <= MICROBATCHES that divides the
    per-device batch (halving clamp — keeps small smoke batches legal
    on larger dp meshes)."""
    k = MICROBATCHES
    while k > 1 and (gb // max(ndev, 1)) % k:
        k //= 2
    return k


def base_state(ctx, arch: str):
    """``(config, opt config, params, opt_state, model_scale, n_params)``
    on the run's device, built once per arch: the reference's reduced
    config on the CPU, the full one on a card."""
    def make():
        c, scale = get_config(arch), "full"
        if ctx.device.type == "cpu":
            c = c.reduced(d_model=128, n_layers=4, d_ff=512, vocab=8192,
                          n_heads=4, n_kv_heads=4, d_head=32)
            scale = "reduced"
        oc = OptConfig(warmup=2, total_steps=1000)
        gen = torch.Generator(device=ctx.device).manual_seed(SEED)
        params, opt_state = init_train_state(c, oc, gen, ctx.device)
        n_params = sum(p.numel() for p in tree.leaves(params))
        return c, oc, params, opt_state, scale, n_params

    return ctx.memo(("llm_train", arch), make)


def _plan(ctx, c, params, placement: Placement):
    """The placement's plan and ZeRO-1 layout, once per placement."""
    def make():
        plan = shd.make_plan(c, ctx.mesh(placement),
                             ShapeConfig("bench", 0, 0, "train"))
        return plan, shd.Zero1(plan, params, c)

    return ctx.memo(("llm_train_plan", c.name, placement.label), make)


def _step(ctx, c, oc, params, placement: Placement, gb: int, mode: str):
    plan, zero = _plan(ctx, c, params, placement)
    k = _microbatches(gb, shd.dp_size(plan))

    def make():
        sync = gs.default_sync(mode, ctx.device)
        sc = StepConfig(microbatches=k)
        return gs.make_dp_train_step(c, oc, sc, plan=plan, sync=sync,
                                     zero=zero), sync

    step, sync = ctx.memo(("llm_train_step", c.name, placement.label, gb,
                           mode), make)
    return step, sync, zero, k


@workload(
    "llm_train",
    analog="Fig. 2 (LLM tokens/s + energy vs global batch, dp-scaled)",
    space=Space({"arch": ["gpt-800m"], "global_batch": [16, 32, 64],
                 "seq": [128], "placement": ["dp1", "dp2", "dp4"],
                 "grad_sync": ["fp32", "int8"]}),
    smoke={"global_batch": [8], "seq": [64], "placement": ["dp1", "dp2"],
           "grad_sync": ["fp32"]},
    tags=("train", "smoke", "full"),
    result_columns=["arch", "global_batch", "seq", "placement",
                    "grad_sync", "tokens_per_s", "tok_s_per_device",
                    "scaling_efficiency", "ms_per_step",
                    "energy_wh_per_step", "tokens_per_wh",
                    "wh_per_token_scaling", "power_source"],
    primary_metric="tokens_per_s",
)
def build(pt, ctx):
    """LLM train-step sweep over global batch x device placement."""
    arch, gb, seq = pt["arch"], pt["global_batch"], pt["seq"]
    c, oc, params, opt_state, scale, n_params = base_state(ctx, arch)
    step, sync, zero, k = _step(ctx, c, oc, params,
                                Placement.of(pt.get("placement", 1)), gb,
                                pt.get("grad_sync", "fp32"))
    toks = torch.from_numpy(synthetic_tokens(gb, seq, c.vocab)[:, :seq])
    toks = toks.to(ctx.device)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    cuda = ctx.device.type == "cuda"

    def train():
        # the step updates its state in place, and the base state is
        # memoized across cells and retries: each cell trains a copy
        p = tree.tree_map(torch.Tensor.clone, params)
        o = shd.shard_opt_state(zero, opt_state)
        s = gs.init_sync_state(p, sync)
        losses = []

        def one():
            nonlocal p, o, s
            p, o, s, m = step(p, o, s, batch)
            losses.append(m["loss"])
            return m["loss"]

        if cuda:
            torch.cuda.reset_peak_memory_stats(ctx.device)
        m = ctx.measure(one)
        measured = [float(x) for x in losses[m.warmup:]]
        out = {"tokens_per_s": tokens_per_s(gb, seq, m.seconds),
               "ms_per_step": m.ms, "seconds": m.seconds,
               "energy_wh_per_step": m.energy_wh,
               "tokens_per_wh": (gb * seq / m.energy_wh)
               if m.energy_wh > 0 else 0.0,
               "loss_first": measured[0], "loss_last": measured[-1],
               "microbatches": k,
               "model_scale": scale, "n_params": n_params}
        if cuda:
            out["peak_mem_gb"] = (torch.cuda.max_memory_allocated(ctx.device)
                                  / 1e9)
        return out

    return {"train": train}
