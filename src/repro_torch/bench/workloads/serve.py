"""Serving workload: continuous vs fixed batching x slotted vs paged KV.

Port of ``src/repro/bench/workloads/serve.py``. The MLPerf-Power/CARAML
serving point: drive the ServeEngine with a seeded synthetic Poisson
arrival process and a bimodal short/long token mix, per (slots x rate x
cache x policy x kv_dtype x sched) cell:

  decode_tok_s    useful generated tokens per wall second
  ttft_s          mean time-to-first-token (includes queueing)
  wh_per_token    energy per generated token (attributed per request)
  wh_per_request  energy per served request
  occupancy       mean decode-step batch occupancy (active/n_slots)
  speedup_vs_fixed    continuous/fixed tokens/s for the same cell
  speedup_vs_slotted  paged/slotted tokens/s for the same cell

Each axis flips one thing, as in the reference: ``policy`` only
admission (``speedup_vs_fixed``), ``cache`` only the KV layout (dense
``max_len`` rows through ``sdpa`` vs block tables through the paged
decode kernel, ``speedup_vs_slotted``), ``sched`` only the prefill
schedule (``speedup_vs_phased``; chunked needs the paged cache, so the
Space drops chunked x slotted), ``kv_dtype`` the paged pool's layout
(int8 codes + per-(block, KV head) scales, continuous paged cells only:
``pool_bytes``/``max_concurrency``, ``speedup_vs_fp_kv`` and
``kv_stream_prefix_agreement`` against the fp twin's greedy streams).

What differs from the reference:

  * **Kernels.** The reference's ``REPRO_PAGED_IMPL`` switch and its
    interpret-mode drill have no port: on a card every paged cell runs
    the CUDA kernels (``kernels.ops``), and on the CPU the plain
    versions. Each record counts the kernel launches of its measured run
    (``decode_launches``, ``decode_launches_int8``, ``prefill_launches``,
    ``prefill_launches_int8``) beside its ``decode_micro_steps``.
  * **Model scale.** On the CPU the cell serves
    ``get_config(arch).reduced()``, the reference's cell, so its columns
    and ``n_tokens`` can be held against the reference's. On a card it
    serves the full-width, full-depth model in bf16 from seeded random
    weights: a reduced model on a card times only the host. ``bench run
    --layers N`` cuts the depth to N layers, widths unchanged
    (``model_scale`` ``full_width`` on a card). Every record says which
    (``model_scale``: ``reduced``, ``full`` or ``full_width``) and
    carries ``n_params`` and ``n_layers``. The traffic is the
    reference's at every scale.
  * **Energy** comes from the runner-selected power backend, labelled
    ``power_source``: on a card ``--power auto`` reads NVML's energy
    counter (``nvml_energy``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.bench.context import Measurement
from repro_torch.bench.spec import workload
from repro_torch.configs import get_config
from repro_torch.core.params import Space
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.prefill_attention import paged_prefill_attention
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.requests import poisson_requests

PROMPT_LEN = 8          # fixed: one prefill trace for the whole sweep
MAX_LEN = 96            # slot capacity (multiple of reduced ssm_chunk)
BLOCK_SIZE = 16         # paged KV block (tokens); 6 blocks per full slot
N_REQUESTS = 48
N_REQUESTS_SMOKE = 64   # enough that the drain tail amortizes away
SEED = 0


def model(ctx, arch: str):
    """``(config, params, model_scale, n_params)`` for ``arch`` on the
    run's device, built once per run: the reduced config on the CPU, the
    full one on a card, cut to ``ctx.layers`` layers when the run asks
    (see the module docstring)."""
    def make():
        c = get_config(arch)
        scale = "full"
        if ctx.device.type == "cpu":
            c, scale = c.reduced(), "reduced"
        if ctx.layers is not None and ctx.layers != c.n_layers:
            c = dataclasses.replace(c, n_layers=ctx.layers)
            scale = "full_width" if scale == "full" else scale
        gen = torch.Generator(device=ctx.device).manual_seed(SEED)
        params = lm.init(c, gen, ctx.device)
        n_params = sum(t.numel() for t in _leaves(params))
        return c, params, scale, n_params

    return ctx.memo(("model", arch), make)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def launch_counts() -> dict:
    """The decode and prefill kernels' launch counters, by path."""
    counts = ops.launch_counts()
    return {
        "decode_launches": counts["paged_decode_attention"],
        "decode_launches_int8": paged_decode_attention.launches_int8,
        "prefill_launches": counts["paged_prefill_attention"],
        "prefill_launches_int8": paged_prefill_attention.launches_int8,
    }


def serve_counted(engine: ServeEngine, requests, **kw):
    """``engine.serve`` with the kernel launches it made (counter deltas,
    so the counters keep counting for whoever reads them around the
    whole run) and its decode micro-steps."""
    before = launch_counts()
    out = engine.serve(requests, **kw)
    after = launch_counts()
    counted = {k: after[k] - before[k] for k in after}
    counted["decode_micro_steps"] = sum(
        s.n_steps for s in out.steps if s.kind == "decode")
    counted["paged_prefills"] = engine.paged_prefills
    return out, counted


def _engine(ctx, arch: str, n_slots: int, cache: str,
            kv_dtype: str = "fp32") -> ServeEngine:
    def make():
        c, params, _scale, _n = model(ctx, arch)
        engine = ServeEngine(c, params, n_slots=n_slots, max_len=MAX_LEN,
                             cache=cache, block_size=BLOCK_SIZE,
                             kv_dtype=kv_dtype, device=ctx.device,
                             power_methods=ctx.power_methods)
        # warmup: first calls (CUDA context, library handles, allocator
        # pools) stay outside any measured cell
        engine.warmup(prompt_len=PROMPT_LEN)
        return c, engine

    return ctx.memo(("serve", arch, n_slots, cache, kv_dtype), make)


def streams_of(out) -> dict:
    """rid -> token tuple of a serve run."""
    return {r.rid: tuple(r.tokens) for r in out.results}


def stream_agreement(ref_streams: dict, cur_streams: dict) -> float:
    """Mean longest-common-prefix fraction of per-request token streams
    against the reference run: 1.0 = bit-identical generation, lower =
    quantization (or a scheduler bug) steered greedy decoding off the
    reference trajectory at 1-lcp/len of the way through an average
    request. Keyed by rid so completion-order differences don't count."""
    fracs = []
    for rid, rt in ref_streams.items():
        ct = cur_streams.get(rid)
        if ct is None:
            continue
        lcp = 0
        for a, b in zip(rt, ct):
            if a != b:
                break
            lcp += 1
        fracs.append(lcp / max(len(rt), len(ct), 1))
    return sum(fracs) / max(len(fracs), 1)


@workload(
    "serve",
    analog="serving: continuous batching + Wh/token (MLPerf-Power style)",
    space=Space({"arch": ["llama3.2-3b"], "slots": [4, 8],
                 "rate_hz": [100.0, 400.0],
                 "cache": ["slotted", "paged"],
                 "policy": ["fixed", "continuous"],
                 # kv_dtype expands before sched, so an int8 cell's fp32
                 # twin (same sched) is always measured first; int8 only
                 # exists for the paged continuous cells
                 "kv_dtype": ["fp32", "int8"],
                 # last axis -> phased expands before chunked for every
                 # cell, so the vs_phased ratio's twin is always cached
                 "sched": ["phased", "chunked"]},
                constraints=[lambda pt: not (pt["sched"] == "chunked"
                                             and pt["cache"] == "slotted"),
                             lambda pt: pt["kv_dtype"] == "fp32"
                             or (pt["cache"] == "paged"
                                 and pt["policy"] == "continuous")]),
    smoke={"slots": [4], "rate_hz": [300.0]},
    tags=("serve", "smoke", "full"),
    result_columns=["arch", "cache", "policy", "sched", "kv_dtype",
                    "slots", "rate_hz",
                    "n_tokens", "decode_tok_s", "ttft_s", "occupancy",
                    "wh_per_token", "wh_per_request", "speedup_vs_fixed",
                    "speedup_vs_slotted", "speedup_vs_phased",
                    "pool_bytes", "max_concurrency", "speedup_vs_fp_kv",
                    "kv_stream_prefix_agreement", "power_source"],
    primary_metric="decode_tok_s",
    # mean TTFT includes queueing, whose depth is set by host speed
    # during admission: a wide stamp catches only a real cliff
    compare_tols={"ttft_s": 2.0},
)
def build(pt, ctx):
    """Continuous vs fixed batching, slotted vs paged KV, Poisson load."""
    c, engine = _engine(ctx, pt["arch"], pt["slots"], pt["cache"],
                        pt["kv_dtype"])
    _c, _params, scale, n_params = model(ctx, pt["arch"])
    n_layers = _c.n_layers
    n = N_REQUESTS_SMOKE if ctx.smoke else N_REQUESTS
    requests = poisson_requests(n, pt["rate_hz"], c.vocab,
                                prompt_len=PROMPT_LEN, seed=SEED)

    def run_cell():
        # two full repetitions of the cell: the second (steady-state) run
        # is reported, and the pair's throughput disagreement becomes the
        # record's same-point noise figure (source=measure_split)
        first_out = engine.serve(requests, policy=pt["policy"],
                                 sched=pt["sched"])
        first = first_out.summary
        out, counted = serve_counted(engine, requests, policy=pt["policy"],
                                     sched=pt["sched"])
        s = out.summary
        pair = sorted((first.decode_tok_s, s.decode_tok_s))
        spread = ((pair[1] - pair[0]) / ((pair[0] + pair[1]) / 2)
                  if pair[1] > 0 else 0.0)
        ctx.last_measurement = Measurement(
            seconds=s.wall_s, energy_wh=s.attributed_wh,
            power_source=ctx.power_source, iters=2, warmup=0,
            rel_spread=spread)
        metrics = {
            "n_requests": s.n_requests,
            "n_tokens": s.n_tokens,
            "decode_tok_s": s.decode_tok_s,
            "ttft_s": s.mean_ttft_s,
            "p95_ttft_s": s.p95_ttft_s,
            "occupancy": s.mean_occupancy,
            "wh_per_token": s.wh_per_token,
            "wh_per_request": s.wh_per_request,
            "overhead_wh": s.overhead_wh,
            "wall_s": s.wall_s,
            "seconds": s.wall_s,
            # the arrival-process seed rides along so a record is fully
            # reproducible from its own row
            "request_seed": SEED,
            "model_scale": scale,
            "n_params": n_params,
            "n_layers": n_layers,
            **counted,
        }
        # headline ratios. The twin cells are normally already cached
        # (the Space expands cache=slotted before paged and policy=fixed
        # before continuous), but a filtered run (--points ...) still
        # gets speedup_vs_fixed: that baseline is measured on demand.
        cells = ctx.cache.setdefault("serve_cells", {})
        cell_key = (pt["arch"], pt["slots"], pt["rate_hz"], pt["cache"],
                    pt["kv_dtype"], pt["sched"])
        cells.setdefault(cell_key, {})[pt["policy"]] = metrics
        if pt["cache"] == "paged":
            # structural capacity story: actual pool bytes (int8 blocks +
            # scales when quantized), what the same block count costs at
            # the native KV dtype, and how many worst-case-length
            # requests fit the fp byte budget (see PagedKVCache)
            metrics["pool_bytes"] = engine._paged.pool_bytes
            metrics["pool_bytes_fp"] = engine._paged.pool_bytes_fp
            metrics["max_concurrency"] = engine._paged.max_concurrency
        # int8 vs fp32 twin: throughput/energy ratios plus the
        # token-stream quality figure (streams keyed without kv_dtype so
        # the int8 cell finds its fp32 reference run)
        streams = ctx.cache.setdefault("serve_streams", {})
        skey = (pt["arch"], pt["slots"], pt["rate_hz"], pt["cache"],
                pt["policy"], pt["sched"])
        my_streams = streams_of(out)
        # how far the greedy streams moved between the two runs, and
        # against the slotted and phased twins (equal on the CPU, where
        # the arithmetic does not depend on the batch; see PERF.md)
        metrics["stream_agreement_run2"] = stream_agreement(
            streams_of(first_out), my_streams)
        by_cell = ctx.cache.setdefault("serve_cell_streams", {})
        by_cell[cell_key + (pt["policy"],)] = my_streams
        for name, twin in (
                ("slotted", cell_key[:3] + ("slotted",) + cell_key[4:]),
                ("phased", cell_key[:5] + ("phased",))):
            ref = by_cell.get(twin + (pt["policy"],))
            if twin != cell_key and ref is not None:
                metrics[f"stream_agreement_vs_{name}"] = stream_agreement(
                    ref, my_streams)
        if pt["kv_dtype"] == "fp32":
            streams[skey] = my_streams
        else:
            fp_key = cell_key[:4] + ("fp32",) + cell_key[5:]
            fp = cells.get(fp_key, {}).get(pt["policy"])
            if fp is not None:   # absent only under --points filters
                metrics["speedup_vs_fp_kv"] = (
                    metrics["decode_tok_s"]
                    / max(fp["decode_tok_s"], 1e-9))
                metrics["wh_per_token_vs_fp_kv"] = (
                    metrics["wh_per_token"]
                    / max(fp["wh_per_token"], 1e-12))
            ref = streams.get(skey)
            if ref is not None:
                metrics["kv_stream_prefix_agreement"] = stream_agreement(
                    ref, my_streams)
        if pt["policy"] == "continuous":
            fixed = cells[cell_key].get("fixed")
            if fixed is None:
                baseline = engine.serve(requests, policy="fixed",
                                        sched=pt["sched"])
                fixed = {"decode_tok_s": baseline.summary.decode_tok_s}
                cells[cell_key]["fixed"] = fixed
            metrics["speedup_vs_fixed"] = (
                metrics["decode_tok_s"] / max(fixed["decode_tok_s"], 1e-9))
        if pt["cache"] == "paged":
            # slotted twin is always fp32 (no quantized slotted cells)
            slot_key = (pt["arch"], pt["slots"], pt["rate_hz"], "slotted",
                        "fp32", pt["sched"])
            slotted = cells.get(slot_key, {}).get(pt["policy"])
            if slotted is not None:   # absent for chunked (no slotted twin)
                metrics["speedup_vs_slotted"] = (
                    metrics["decode_tok_s"]
                    / max(slotted["decode_tok_s"], 1e-9))
        if pt["sched"] == "chunked":
            phase_key = (pt["arch"], pt["slots"], pt["rate_hz"],
                         pt["cache"], pt["kv_dtype"], "phased")
            phased = cells.get(phase_key, {}).get(pt["policy"])
            if phased is not None:   # absent only under --points filters
                metrics["speedup_vs_phased"] = (
                    metrics["decode_tok_s"]
                    / max(phased["decode_tok_s"], 1e-9))
        return metrics

    return {"serve": run_cell}
