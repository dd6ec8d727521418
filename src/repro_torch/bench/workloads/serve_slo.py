"""Multi-tenant SLO serving workload: goodput + Wh-per-SLO-met-request.

Port of ``src/repro/bench/workloads/serve_slo.py``. The MLPerf-Power
framing on top of the continuous-batching engine: drive the ServeEngine
with seeded multi-tenant traces (``serve.traffic`` presets — Poisson
mixes, MMPP bursts, shared system-prompt populations) and score every
request against its tenant's TTFT/TPOT SLO (``serve.slo``), per (trace x
cache x kv_dtype x sched) cell:

  goodput             fraction of requests meeting BOTH targets
  ttft_p99 / tpot_p99 tail latency (nearest-rank, includes queueing)
  wh_per_slo_request  attributed energy / SLO-met requests

The ``cache`` axis isolates prefix caching (``paged+prefix`` adopts the
shared KV of a prompt's leading blocks and prefills only its suffix,
over the prefix in the pool: the paged prefill kernel); the ``sched``
axis iteration-level scheduling (``chunked`` interleaves block-aligned
prefill slices, every one after the first through the paged prefill
kernel, and preempts on a tight pool: ``long_prefill`` runs against
``POOL_BY_TRACE``'s 17 blocks); ``kv_dtype`` puts the plain-paged phased
cells on an int8 pool. ``stream_hash`` (an order-independent digest of
every request's tokens) must agree across the sched and cache axes;
``preemptions`` counts chunked evictions.

The SLO targets are the reference's, set for its reduced CPU cell (~30x
that cell's steady-state tail); the port keeps them at either model
scale, so goodput at full width is a finding, not a tuned figure.

What differs from the reference is what differs in the ``serve``
workload (``bench/workloads/serve.py``): no ``REPRO_PAGED_IMPL`` switch
or interpret-mode drill (a card always runs the kernels, the CPU the
plain versions), the reduced model on the CPU and the full-width bf16
model on a card, cut in depth by ``--layers`` (``model_scale``,
``n_params``, ``n_layers``), kernel launch counts
per record, and energy from the runner's backend (``nvml_energy`` on a
card under ``--power auto``).
"""
from __future__ import annotations

import hashlib

from repro_torch.bench.context import Measurement
from repro_torch.bench.spec import workload
from repro_torch.bench.workloads.serve import (
    model, serve_counted, stream_agreement, streams_of,
)
from repro_torch.core.params import Space
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.slo import SLO, evaluate_slo
from repro_torch.serve.traffic import TRACE_NAMES, generate_trace, preset_trace

MAX_LEN = 96            # slot capacity (prompt + budget; see traffic presets)
BLOCK_SIZE = 16         # paged KV block; shared_prefix pins 3 full blocks
N_SLOTS = 4
N_REQUESTS = 96
N_REQUESTS_SMOKE = 48
SEED = 0

#: generous CPU-cell targets (~30x the reduced-config steady-state tail).
#: Interactive tenants get the tight budget; batch-flavored tenants
#: (bursty "batch", shared_prefix "misc") tolerate double.
SLO_TIGHT = SLO(ttft_s=2.0, tpot_s=0.2)
SLO_RELAXED = SLO(ttft_s=4.0, tpot_s=0.4)
#: batch-flavored tenants tolerate double; long_prefill's "doc" tenant
#: is offline-flavored AND pays an unavoidable 5-chunk prefill
SLO_BY_TENANT = {"batch": SLO_RELAXED, "misc": SLO_RELAXED,
                 "doc": SLO_RELAXED}

#: per-trace paged-pool override (blocks). long_prefill runs against a
#: TIGHT pool: 17 blocks = trash + 16 usable, so two live worst-case
#: generations (6 blocks each) plus a document prompt (6) oversubscribe
#: it — the regime where phased defers admissions behind gen lifetimes
#: and chunked preempts its way through. Other traces keep the engine's
#: ample default pool.
POOL_BY_TRACE = {"long_prefill": 17}


def _stream_hash(results) -> str:
    """Order-independent sha1 over {rid: tokens}: completion order (and
    therefore results-list order) differs across scheduler modes, so the
    digest sorts by rid before hashing."""
    blob = repr(sorted((r.rid, tuple(r.tokens)) for r in results))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _engine(ctx, arch: str, cache: str,
            n_blocks=None, kv_dtype: str = "fp32") -> ServeEngine:
    def make():
        c, params, _scale, _n = model(ctx, arch)
        engine = ServeEngine(c, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                             cache="paged", block_size=BLOCK_SIZE,
                             n_blocks=n_blocks,
                             prefix_cache=cache == "paged+prefix",
                             kv_dtype=kv_dtype, device=ctx.device,
                             power_methods=ctx.power_methods)
        return c, engine

    return ctx.memo(("serve_slo", arch, cache, n_blocks, kv_dtype), make)


@workload(
    "serve_slo",
    analog="multi-tenant SLO serving: goodput + Wh/SLO-met-request "
           "(MLPerf-Power style), prefix-cached prefill",
    space=Space({"arch": ["llama3.2-3b"], "trace": list(TRACE_NAMES),
                 "cache": ["paged", "paged+prefix"],
                 # int8 pools ride only the plain-paged phased cells
                 # here (fp32 expands first, so the int8 cell's twin is
                 # cached); the serve workload owns the full cross
                 "kv_dtype": ["fp32", "int8"],
                 # last axis -> phased expands before chunked for every
                 # cell, so the vs_phased ratio's twin is always cached
                 "sched": ["phased", "chunked"]},
                constraints=[lambda pt: pt["kv_dtype"] == "fp32"
                             or (pt["cache"] == "paged"
                                 and pt["sched"] == "phased")]),
    smoke={"trace": ["poisson", "shared_prefix", "long_prefill"]},
    tags=("serve", "smoke", "full"),
    result_columns=["arch", "trace", "cache", "sched", "kv_dtype",
                    "goodput",
                    "ttft_p99", "tpot_p99", "wh_per_slo_request",
                    "decode_tok_s", "prefix_hit_requests", "preemptions",
                    "ttft_p99_vs_paged", "wh_per_slo_vs_paged",
                    "ttft_p99_vs_phased", "goodput_vs_phased",
                    "speedup_vs_phased", "pool_bytes", "max_concurrency",
                    "speedup_vs_fp_kv", "kv_stream_prefix_agreement",
                    "trace_hash", "power_source"],
    primary_metric="goodput",
    # tail quantiles of a single run are scheduling-event-sized: these
    # stamps gate them only against order-of-magnitude cliffs
    compare_tols={"ttft_p99": 4.0, "tpot_p99": 1.5,
                  "ttft_p99_vs_phased": 6.0},
)
def build(pt, ctx):
    """Multi-tenant traces x prefix caching, scored against SLOs."""
    c, engine = _engine(ctx, pt["arch"], pt["cache"],
                        n_blocks=POOL_BY_TRACE.get(pt["trace"]),
                        kv_dtype=pt["kv_dtype"])
    _c, _params, scale, n_params = model(ctx, pt["arch"])
    n = N_REQUESTS_SMOKE if ctx.smoke else N_REQUESTS
    cfg = preset_trace(pt["trace"], n_requests=n, vocab=c.vocab, seed=SEED)
    requests = generate_trace(cfg)

    # warm once per (engine, trace): repeat=2 lets a prefix engine
    # register on the first pass and take the hit path on the second.
    # The index is cleared afterwards, so measured runs start cold.
    warmed = ctx.cache.setdefault("slo_warmed", set())
    wkey = (pt["arch"], pt["cache"], pt["trace"], pt["sched"],
            pt["kv_dtype"])
    if wkey not in warmed:
        engine.warmup(requests=requests,
                      repeat=2 if engine.prefix_cache else 1,
                      sched=pt["sched"])
        warmed.add(wkey)

    def run_cell():
        # same twice-run noise protocol as the serve workload: report
        # the steady-state second run, turn the pair's throughput
        # disagreement into the record's same-point noise figure. Each
        # measured run starts from a cold prefix index so the two runs
        # see identical hit sequences.
        def one_run():
            engine.reset_prefix_cache()
            return serve_counted(engine, requests, policy="continuous",
                                 sched=pt["sched"])

        first_out = one_run()[0]
        first = first_out.summary
        out, counted = one_run()
        s = out.summary
        pair = sorted((first.decode_tok_s, s.decode_tok_s))
        spread = ((pair[1] - pair[0]) / ((pair[0] + pair[1]) / 2)
                  if pair[1] > 0 else 0.0)
        ctx.last_measurement = Measurement(
            seconds=s.wall_s, energy_wh=s.attributed_wh,
            power_source=ctx.power_source, iters=2, warmup=0,
            rel_spread=spread)
        report = evaluate_slo(out.results, SLO_BY_TENANT,
                              default=SLO_TIGHT)
        metrics = {
            "goodput": report.goodput,
            "n_met": report.n_met,
            "n_requests": report.n_requests,
            "ttft_p50": report.ttft_p50_s,
            "ttft_p99": report.ttft_p99_s,
            "tpot_p50": report.tpot_p50_s,
            "tpot_p99": report.tpot_p99_s,
            "wh_per_slo_request": report.wh_per_slo_request,
            "n_tokens": s.n_tokens,
            "decode_tok_s": s.decode_tok_s,
            "wh_per_token": s.wh_per_token,
            "occupancy": s.mean_occupancy,
            "wall_s": s.wall_s,
            "seconds": s.wall_s,
            # full provenance: the trace is reproducible from its row
            "trace_seed": SEED,
            "trace_hash": cfg.config_hash(),
            # order-independent digest of every request's token stream:
            # equal across the sched and cache axes (same greedy argmax
            # path), so a quality-affecting scheduler bug shows up as a
            # hash mismatch
            "stream_hash": _stream_hash(out.results),
            "preemptions": engine.preemptions,
            "replayed_tokens": engine.replayed_tokens,
            "model_scale": scale,
            "n_params": n_params,
            "n_layers": _c.n_layers,
            **counted,
        }
        for name, sub in report.per_tenant.items():
            metrics[f"goodput_{name}"] = sub.goodput
        if engine.prefix_cache:
            for key, val in engine.prefix_stats.items():
                metrics[f"prefix_{key}"] = val
        # structural pool capacity columns (every cell here is paged)
        metrics["pool_bytes"] = engine._paged.pool_bytes
        metrics["pool_bytes_fp"] = engine._paged.pool_bytes_fp
        metrics["max_concurrency"] = engine._paged.max_concurrency
        # headline ratios against the twin cells: plain-paged (same
        # sched) and phased (same cache) — both expand earlier in the
        # Space, so they are already measured except under --points
        cells = ctx.cache.setdefault("serve_slo_cells", {})
        cell_key = (pt["arch"], pt["trace"])
        sub_key = (pt["cache"], pt["kv_dtype"], pt["sched"])
        cells.setdefault(cell_key, {})[sub_key] = metrics
        if pt["cache"] == "paged+prefix":
            base = cells[cell_key].get(
                ("paged", pt["kv_dtype"], pt["sched"]))
            if base is not None:   # absent only under --points filters
                metrics["ttft_p99_vs_paged"] = (
                    metrics["ttft_p99"] / max(base["ttft_p99"], 1e-9))
                metrics["wh_per_slo_vs_paged"] = (
                    metrics["wh_per_slo_request"]
                    / max(base["wh_per_slo_request"], 1e-12))
        if pt["sched"] == "chunked":
            base = cells[cell_key].get(
                (pt["cache"], pt["kv_dtype"], "phased"))
            if base is not None:   # absent only under --points filters
                metrics["ttft_p99_vs_phased"] = (
                    metrics["ttft_p99"] / max(base["ttft_p99"], 1e-9))
                metrics["goodput_vs_phased"] = (
                    metrics["goodput"] / max(base["goodput"], 1e-9))
                metrics["speedup_vs_phased"] = (
                    metrics["decode_tok_s"]
                    / max(base["decode_tok_s"], 1e-9))
        # int8 vs fp32 twin: perf/energy ratios + stream quality (same
        # protocol as the serve workload; streams keyed sans kv_dtype)
        streams = ctx.cache.setdefault("serve_slo_streams", {})
        skey = (pt["arch"], pt["trace"], pt["cache"], pt["sched"])
        my_streams = streams_of(out)
        # how far the greedy streams moved between the two runs, and
        # against the plain-paged and phased twins (``stream_hash`` is
        # equal on the CPU; see PERF.md for the card)
        metrics["stream_agreement_run2"] = stream_agreement(
            streams_of(first_out), my_streams)
        by_cell = ctx.cache.setdefault("serve_slo_cell_streams", {})
        by_cell[cell_key + sub_key] = my_streams
        for name, twin in (("paged", ("paged",) + sub_key[1:]),
                           ("phased", sub_key[:2] + ("phased",))):
            ref = by_cell.get(cell_key + twin)
            if twin != sub_key and ref is not None:
                metrics[f"stream_agreement_vs_{name}"] = stream_agreement(
                    ref, my_streams)
        if pt["kv_dtype"] == "fp32":
            streams[skey] = my_streams
        else:
            base = cells[cell_key].get((pt["cache"], "fp32", pt["sched"]))
            if base is not None:   # absent only under --points filters
                metrics["speedup_vs_fp_kv"] = (
                    metrics["decode_tok_s"]
                    / max(base["decode_tok_s"], 1e-9))
                metrics["wh_per_slo_vs_fp_kv"] = (
                    metrics["wh_per_slo_request"]
                    / max(base["wh_per_slo_request"], 1e-12))
            ref = streams.get(skey)
            if ref is not None:
                metrics["kv_stream_prefix_agreement"] = stream_agreement(
                    ref, my_streams)
        return metrics

    return {"serve_slo": run_cell}
