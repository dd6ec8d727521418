"""Paper Table II analog: GPT-117M with PIPELINE parallelism.

Port of ``src/repro/bench/workloads/pipeline_gpt.py``: the reference's
Space (global batch 16 / 32 / 64), smoke preset, ``{"pp": 4}``
placement, tags, result columns and primary metric, its ``SEQ`` (64),
its 8 microbatches, its per-stage layer function and its correctness
gate (:func:`verify_pipeline_correctness`, on full runs). The model's
layers are split over 4 stages, each stage a rank of the mesh's
``stage`` axis (``launch.mesh``), and the forward runs the rotation
schedule of ``parallel.pipeline``; a cell records tokens/s, ms an
iteration, energy and the pipeline bubble's share
(``bubble_fraction``: 3/11 at 4 stages and 8 microbatches).

What differs from the reference:

  * **Placement.** The four stages are four ranks: gloo processes on the
    CPU, one card a rank on cards. A process that cannot place four
    ranks (one card) records every cell as ``deferred`` with its sbatch
    script.
  * **Model scale.** On the CPU a cell runs the reference's reduced
    gpt-117m (8 layers, d_model 128, vocab 4096), so its records can be
    held against the reference's; on cards, full-width gpt-117m (12
    layers, 3 a stage; bf16), from seeded random weights. Every record
    says which (``model_scale``) and carries ``n_params``.
  * **No gradient.** The reference times its jitted forward; the port
    runs it under ``torch.no_grad()``.
"""
from __future__ import annotations

import torch

from repro_torch.bench.spec import Placement, workload
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.core.metrics import tokens_per_s
from repro_torch.core.params import Space
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models.common import apply_mlp, apply_norm
from repro_torch.parallel.pipeline import (
    bubble_fraction, pipeline_forward, stage_params_split,
)

SEQ = 64
N_STAGES = 4
N_MICROBATCH = 8
SEED = 0


def layer_fn_for(c):
    """``layer_fn(stage_params, x)``: a stage's layers in order (the
    reference's scan over the stacked ``slot0`` leaves)."""
    def layer_fn(stage_p, x):
        for i in range(tree.leaves(stage_p)[0].shape[0]):
            sp = tree.tree_map(lambda a: a[i], stage_p)["slot0"]
            h = apply_norm(c, sp["norm1"], x)
            x = x + attn.self_attention(c, sp["attn"], h, causal=True)
            x = x + apply_mlp(c, sp["mlp"], apply_norm(c, sp["norm2"], x))
        return x
    return layer_fn


def config(device: torch.device):
    """``(config, model_scale)``: the reference's reduced gpt-117m on the
    CPU, the full one on cards."""
    c = get_config("gpt-117m")
    if device.type == "cpu":
        return c.reduced(n_layers=8, d_model=128, d_ff=512, n_heads=4,
                         n_kv_heads=4, d_head=32, vocab=4096), "reduced"
    return c, "full"


def _setup(ctx):
    def make():
        c, scale = config(ctx.device)
        gen = torch.Generator(device=ctx.device).manual_seed(SEED)
        params = lm.init(c, gen, ctx.device)
        n_params = sum(p.numel() for p in tree.leaves(params))
        stage_params = stage_params_split(params["layers"], N_STAGES)
        return c, params, stage_params, scale, n_params

    return ctx.memo("pipeline_gpt", make)


def verify_pipeline_correctness(mesh, device) -> dict:
    """Pipeline output == sequential execution of the same layers (the
    reference's gate: a tiny gpt-117m, 4 microbatches, rtol 2e-2)."""
    c = get_config("gpt-117m").reduced(n_layers=4, d_model=64, d_ff=128,
                                       n_heads=2, n_kv_heads=2, d_head=32,
                                       vocab=512)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = lm.init(c, gen, device)
    stage_params = stage_params_split(params["layers"], N_STAGES)
    layer_fn = layer_fn_for(c)
    toks = torch.from_numpy(synthetic_tokens(8, 32, c.vocab)[:, :32])
    with torch.no_grad():
        x = lm._inputs_to_embeds(c, params, toks.to(device), None)
        got = pipeline_forward(mesh, "stage", layer_fn, stage_params,
                               x.reshape(4, 2, 32, c.d_model))
        want = layer_fn(params["layers"], x)
    torch.testing.assert_close(got.reshape(x.shape).float(), want.float(),
                               rtol=2e-2, atol=2e-2)
    return {"pipeline_matches_sequential": 1}


@workload(
    "pipeline_gpt",
    analog="Table II (pipeline-parallel GPT-117M tokens/s)",
    space=Space({"global_batch": [16, 32, 64]}),
    smoke={"global_batch": [16]},
    placement={"pp": N_STAGES},
    tags=("train", "smoke", "full"),
    result_columns=["global_batch", "tokens_per_s", "ms_per_iter",
                    "energy_wh", "tokens_per_wh", "bubble_fraction",
                    "power_source"],
    primary_metric="tokens_per_s",
)
def build(pt, ctx):
    """Pipeline-parallel forward sweep over global batch size."""
    c, params, stage_params, scale, n_params = _setup(ctx)
    mesh = ctx.mesh(Placement.of({"pp": N_STAGES}))
    layer_fn = layer_fn_for(c)
    gb = pt["global_batch"]
    mb = gb // N_MICROBATCH
    toks = torch.from_numpy(synthetic_tokens(gb, SEQ, c.vocab)[:, :SEQ])
    with torch.no_grad():
        x = lm._inputs_to_embeds(c, params, toks.to(ctx.device), None)
    x_mb = x.reshape(N_MICROBATCH, mb, SEQ, c.d_model)

    @torch.no_grad()
    def fwd():
        return pipeline_forward(mesh, "stage", layer_fn, stage_params, x_mb)

    def run():
        m = ctx.measure(fwd)
        return {"tokens_per_s": tokens_per_s(gb, SEQ, m.seconds),
                "ms_per_iter": m.ms, "seconds": m.seconds,
                "energy_wh": m.energy_wh,
                "tokens_per_wh": (gb * SEQ / m.energy_wh)
                if m.energy_wh > 0 else 0.0,
                "bubble_fraction": bubble_fraction(N_STAGES, N_MICROBATCH),
                "model_scale": scale, "n_params": n_params}

    steps = {"run": run}
    if not ctx.smoke:   # correctness gate rides along on full runs only
        steps = {"verify": lambda: verify_pipeline_correctness(
            mesh, ctx.device), "run": run}
    return steps
