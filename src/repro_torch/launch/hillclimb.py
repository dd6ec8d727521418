"""Perf hill-climbing on one H100's roofline.

Port of ``src/repro/launch/hillclimb.py``: runs named optimization
variants over chosen (arch x shape) cells, re-counts each with the dry
run (``launch.dryrun``) and records its roofline terms. Every variant of
one invocation counts on one mesh, so its records compare: ``--mesh
single`` (the default, the reference's: rank 0 of the 256-card mesh),
``multi`` or ``1xh100`` (one H100). Variants:

  baseline      the plan of the mesh (one device: ``launch.dryrun``'s)
  dp_only       the ``model`` axis re-purposed as extra data parallelism
                (``use_tp=False``: no tensor parallelism, the batch over
                every axis; for small archs whose TP is replicated)
  bf16_grads    Megatron's bf16 gradient buffer (``StepConfig.grad_dtype``)
  mbs{N}        micro-batch-size sweep (1, 2, 8)
  flash_attn    the attention core's counted traffic replaced by the
                streaming traffic of the port's flash kernel
                (``csrc/flash_attention.cu``): the core is counted with
                ``models.attention.skip_attention_core`` and without
  seq_parallel  Megatron sequence parallelism: the training stack's
                residual stream cut on the sequence over ``model``, each
                activation all-reduce a reduce-scatter and an all-gather
  moe_dshard    the MoE dispatch buffer's D over ``model`` (expert-
                parallel archs): two all-to-alls a MoE layer where the
                combine was all-reduced; a dense arch counts what
                ``baseline`` counts

Both plan variants are the step the ranks execute, counted on the mesh.
``flash_attn`` models one card's kernel and counts on ``--mesh 1xh100``
only. Variants combine with ``+`` (``mbs2+moe_dshard``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --cell qwen2-0.5b:train_4k --variant baseline --variant dp_only
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --mesh 1xh100 \\
      --cell qwen2-0.5b:prefill_32k --variant baseline --variant flash_attn
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.models import attention as attn_mod
from repro_torch.roofline import analysis as roof

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "hillclimb_torch"

VARIANTS: dict[str, dict] = {
    "baseline": {},
    "bf16_grads": {"step": {"grad_dtype": "bfloat16"}},
    "flash_attn": {},
    "mbs1": {"mbs": 1}, "mbs2": {"mbs": 2}, "mbs8": {"mbs": 8},
    "dp_only": {"plan": {"use_tp": False, "tp_heads": False, "ep": False,
                         "attn_impl": "grouped"}},
    "seq_parallel": {"plan": {"seq_parallel": True}},
    "moe_dshard": {"plan": {"moe_dshard": True}},
}

#: (query, group) rows a block of the bf16 flash kernel streams K/V for
#: (``kRows`` of ``csrc/attention_mma.cuh``, which the flash kernel runs)
FLASH_ROWS = 64


def run_variant(arch: str, shape_name: str, variant: str,
                out_dir: pathlib.Path = ART,
                mesh: str = "single") -> dict:
    """Count one variant of one cell on ``mesh`` (the reference's
    ``single`` by default) and write its record."""
    c = get_config(arch)
    shape = SHAPES[shape_name]
    kw: dict = {}
    plan: dict = {}
    flash = False
    for part in variant.split("+"):
        if part not in VARIANTS:
            raise ValueError(f"unknown variant {part!r}: {sorted(VARIANTS)}")
        spec = VARIANTS[part]
        if "mbs" in spec:
            kw["microbatch_size"] = spec["mbs"]
        if "step" in spec:
            kw.setdefault("step_overrides", {}).update(spec["step"])
        plan.update(spec.get("plan", {}))
        flash = flash or part == "flash_attn"
    if plan.get("use_tp") is False:     # every axis carries the batch
        plan["dp"] = ("pod", "data", "model") if mesh == "multi" \
            else ("data", "model")
    if flash and mesh != dryrun.MESH:
        raise ValueError("flash_attn models one card's kernel: --mesh "
                         f"{dryrun.MESH}")
    rec = dryrun.lower_cell(c, shape, mesh, plan_overrides=plan or None,
                            **kw)
    if flash:
        rec = _apply_flash_model(c, shape, rec, **kw)
    rec["variant"] = variant
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{arch}__{shape_name}__{variant}.json").write_text(
        json.dumps(rec, indent=1))
    return rec


def _apply_flash_model(c, shape, rec, **kw):
    """Count the cell with the attention core stubbed out, then put the
    flash kernel's streaming model (q/k/v/o traffic only) in the place
    of the core's counted traffic."""
    with attn_mod.skip_attention_core():
        got, _k = dryrun.cell_counts(c, shape, **kw)
    full = rec["cost_analysis"]
    attn_bytes = max(full["bytes_accessed"] - got.bytes, 0.0)
    attn_flops = max(full["flops"] - got.flops, 0.0)
    # streaming model: q, o read and written once; each block of
    # FLASH_ROWS (query, group) rows of one KV head reads that head's
    # K and V once; the fp32 accumulators stay on chip. Training counts
    # the forward, its recompute and the backward (x3), as the reference.
    b, s = shape.global_batch, shape.seq_len
    g = c.n_heads // max(c.n_kv_heads, 1)
    nq = max(-(-s * g // FLASH_ROWS), 1)
    n_attn = sum(c.is_attn_layer(i) for i in range(c.n_layers))
    qo = 2 * b * s * c.n_heads * c.d_head * 2
    kv = 2 * b * s * (c.n_kv_heads or 1) * c.d_head * 2 * nq
    passes = 3 if shape.kind == "train" else 1
    flash_bytes = n_attn * (qo + kv) * passes
    new_bytes = got.bytes + flash_bytes
    r = roof.analyze(
        c, shape, mesh_name=rec["mesh"], n_devices=rec["n_devices"],
        flops_per_device=full["flops"], hbm_bytes_per_device=new_bytes,
        wire_bytes_per_device=rec["collectives"]["total_wire_bytes"])
    rec["flash_model"] = {
        "attn_core_bytes_measured": attn_bytes,
        "attn_core_flops_measured": attn_flops,
        "flash_streaming_bytes": flash_bytes,
    }
    rec["cost_analysis"]["bytes_accessed"] = new_bytes
    rec["roofline"] = r.to_dict()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="append", required=True,
                    help="arch:shape, e.g. qwen2-0.5b:train_4k")
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=[*dryrun.PRODUCTION, dryrun.MESH],
                    help="the mesh every variant counts on")
    ap.add_argument("--out", default=str(ART))
    args = ap.parse_args(argv)
    variants = args.variant or ["baseline"]
    for cell in args.cell:
        arch, shape_name = cell.split(":")
        for v in variants:
            try:
                rec = run_variant(arch, shape_name, v, pathlib.Path(args.out),
                                  args.mesh)
                rf = rec["roofline"]
                print(f"[hillclimb] {arch} {shape_name} {v:14s} "
                      f"comp={rf['compute_s']:.3f} mem={rf['memory_s']:.3f} "
                      f"coll={rf['collective_s']:.3f} "
                      f"bottleneck={rf['bottleneck']:10s} "
                      f"frac={rf['roofline_fraction']:.3f}")
            except Exception as e:  # noqa: BLE001 - report and go on
                print(f"[hillclimb] {arch} {shape_name} {v}: "
                      f"FAIL {type(e).__name__}: {str(e)[:200]}")


if __name__ == "__main__":
    main()
