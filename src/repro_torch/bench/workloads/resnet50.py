"""Paper Fig. 3 / Table III analog: ResNet50 training throughput + energy.

Port of ``src/repro/bench/workloads/resnet50.py``: the reference's
Space, smoke preset, tags, result columns and primary metric. Each cell
trains ResNet50 v1.5 with ``train.step.make_resnet_train_step`` on one
synthetic batch (seed 0) that repeats every step, with
``OptConfig(warmup=2, total_steps=1000)``, and records images/s,
ms/step, energy/step and images/Wh; the runner stamps
``tok_s_per_device`` (images per device), as in the reference.

What differs from the reference:

  * **Placement.** A dpN cell runs in N ranks (``launch.mesh``) under
    ``make_dp_plan``, as the reference's: params replicate, each rank
    trains on its rows of the global batch, BatchNorm's statistics are
    over every rank's rows (the reference's GSPMD step computes them
    over the global batch), the gradients are all-reduced (Horovod's
    all-reduce) and AdamW's state is cut to ZeRO-1 slices. A cell the
    process cannot place (dp2 on one card) is ``deferred`` with its
    sbatch script.
  * **Model scale.** On the CPU a cell trains the reference's reduced
    config (``CONFIG.reduced(img_size=64, width=16)``), so its records
    can be held against the reference's; on a card, full-width,
    full-depth ResNet50 (stages (3, 4, 6, 3), width 64, 1000 classes,
    224x224 images; bf16 params and compute, fp32 master weights and
    moments) from seeded random weights. Every record says which
    (``model_scale``) and carries ``n_params``.
  * **State.** The base state is built once from a ``torch.Generator``
    seeded with 0. The step updates its state in place (the reference
    donates it), so each cell trains its own copy.
  * **Extra columns.** ``loss_first`` / ``loss_last`` are the losses of
    the first and last measured step (the batch repeats, so the loss
    falls); on a card ``peak_mem_gb`` is ``torch.cuda.max_memory_allocated``
    over the cell and ``model_flop_share`` is the model's operations
    (``resnet.forward_flops``, three times for forward and backward)
    over the step time against the H100's dense bf16 peak.
"""
from __future__ import annotations

import torch

from repro_torch.bench.spec import Placement, workload
from repro_torch.configs.resnet50 import CONFIG
from repro_torch.core import tree
from repro_torch.core.metrics import PEAK_FLOPS_BF16, images_per_s
from repro_torch.core.params import Space
from repro_torch.data.synthetic import synthetic_images
from repro_torch.models import resnet
from repro_torch.parallel import sharding as shd
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import init_train_state, make_resnet_train_step

SEED = 0


def base_state(ctx):
    """``(config, opt config, params, opt_state, model_scale, n_params)``
    on the run's device, built once: the reference's reduced config on
    the CPU, the full one on a card."""
    def make():
        c, scale = CONFIG, "full"
        if ctx.device.type == "cpu":
            c, scale = CONFIG.reduced(img_size=64, width=16), "reduced"
        oc = OptConfig(warmup=2, total_steps=1000)
        gen = torch.Generator(device=ctx.device).manual_seed(SEED)
        params, opt_state = init_train_state(c, oc, gen, ctx.device)
        n_params = sum(p.numel() for p in tree.leaves(params))
        return c, oc, params, opt_state, scale, n_params

    return ctx.memo("resnet50", make)


@workload(
    "resnet50",
    analog="Fig. 3 / Table III (ResNet50 images/s + energy, dp-scaled)",
    space=Space({"global_batch": [16, 32, 64],
                 "placement": ["dp1", "dp2", "dp4"]}),
    smoke={"global_batch": [8], "placement": ["dp1", "dp2"]},
    tags=("vision", "train", "smoke", "full"),
    result_columns=["global_batch", "placement", "images_per_s",
                    "tok_s_per_device", "scaling_efficiency",
                    "ms_per_step", "energy_wh_per_step", "images_per_wh",
                    "wh_per_token_scaling", "power_source"],
    primary_metric="images_per_s",
)
def build(pt, ctx):
    """ResNet50 train-step sweep over global batch x device placement."""
    c, oc, params, opt_state, scale, n_params = base_state(ctx)

    placement = Placement.of(pt.get("placement", 1))

    def placed():
        plan = shd.make_dp_plan(ctx.mesh(placement))
        zero = shd.Zero1(plan, params)
        return make_resnet_train_step(c, oc, plan=plan, zero=zero), zero

    step, zero = ctx.memo(("resnet50_placed", placement.label), placed)
    gb = pt["global_batch"]
    imgs, labels = synthetic_images(gb, c.img_size, c.n_classes)
    batch = {"images": torch.from_numpy(imgs).to(ctx.device),
             "labels": torch.from_numpy(labels).to(ctx.device)}
    cuda = ctx.device.type == "cuda"

    def train():
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

        if cuda:
            torch.cuda.reset_peak_memory_stats(ctx.device)
        m = ctx.measure(one)
        measured = [float(x) for x in losses[m.warmup:]]
        out = {"images_per_s": images_per_s(gb, m.seconds),
               "ms_per_step": m.ms, "seconds": m.seconds,
               "energy_wh_per_step": m.energy_wh,
               "images_per_wh": (gb / m.energy_wh)
               if m.energy_wh > 0 else 0.0,
               "loss_first": measured[0], "loss_last": measured[-1],
               "model_scale": scale, "n_params": n_params}
        if cuda:
            out["peak_mem_gb"] = (torch.cuda.max_memory_allocated(ctx.device)
                                  / 1e9)
            out["model_flop_share"] = (3 * resnet.forward_flops(c) * gb
                                       / m.seconds / PEAK_FLOPS_BF16
                                       / zero.mesh.size)
        return out

    return {"train": train}
