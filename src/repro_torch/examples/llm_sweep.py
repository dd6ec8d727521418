"""CARAML-style automated sweep (the paper's core workflow): explore
(global batch x microbatch) for an LLM through the WorkloadSpec API —
runner-owned power selection, constraint filtering, and a final result
table + heatmap — the JUBE ``run -> continue -> result`` flow in one
script.

Port of ``examples/llm_sweep.py``: its model, Space, sequence, result
columns and heatmap. The train step updates params and optimizer state
in place (the reference's jitted step returns new ones), so each timed
call trains on from the last; the time of a step does not depend on the
values. The spec is run directly, not registered.

  PYTHONPATH=src python -m repro_torch.examples.llm_sweep    # on the card
  PYTHONPATH=src python -m repro_torch.examples.llm_sweep --device cpu \
      --power none
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.bench import WorkloadRunner, WorkloadSpec
from repro_torch.configs import get_config
from repro_torch.core import Space, divisible_batch, heatmap
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import (StepConfig, init_train_state,
                                    make_train_step)

SEQ = 64


def build(pt, ctx):
    """Example sweep: power pick, warmup/timing and the per-k step cache
    are ctx/runner-owned."""

    def setup():
        c = get_config("qwen2-0.5b").reduced(vocab=4096)
        oc = OptConfig(warmup=1, total_steps=100)
        gen = torch.Generator(device=ctx.device).manual_seed(0)
        return (c, oc) + init_train_state(c, oc, gen, ctx.device)

    c, oc, params, opt_state = ctx.memo("llm_sweep_state", setup)
    gb, mb = pt["global_batch"], pt["micro_batch"]
    k = gb // mb
    step = ctx.memo(("llm_sweep_step", k), lambda: make_train_step(
        c, oc, StepConfig(microbatches=k)))
    toks = torch.from_numpy(
        synthetic_tokens(gb, SEQ, c.vocab)[:, :SEQ]).to(ctx.device)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    def train():
        m = ctx.measure(lambda: step(params, opt_state, batch)[0])
        return {"tokens_per_s": gb * SEQ / m.seconds,
                "ms_per_step": m.ms, "seconds": m.seconds,
                "energy_wh_per_step": m.energy_wh}

    return {"train": train}


SPEC = WorkloadSpec(
    name="llm_sweep",
    analog="example: (global batch x microbatch) train-step sweep",
    space=Space({"global_batch": [8, 16, 32], "micro_batch": [4, 8],
                 "dp": [1]}, [divisible_batch]),
    build=build, tags=frozenset({"example"}),
    result_columns=["global_batch", "micro_batch", "tokens_per_s",
                    "ms_per_step", "energy_wh_per_step", "power_source"],
    primary_metric="tokens_per_s",
    heatmap_keys=("micro_batch", "global_batch", "tokens_per_s"),
    description="Example sweep: power pick, warmup/timing and the per-k "
                "step cache are ctx/runner-owned.")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--power", default="auto",
                    help="the bench CLI's --power (auto: the card's energy "
                         "counter; raises on the CPU)")
    ap.add_argument("--out", default="artifacts/examples_torch")
    args = ap.parse_args(argv)
    runner = WorkloadRunner(SPEC, device=resolve_device(args.device),
                            out_dir=args.out, power=args.power, retries=2)
    records = runner.run(verbose=True)
    print("\n== result table (jube result analog) ==")
    print(runner.result_table())
    print("== tokens/s heatmap (Fig. 4 analog) ==")
    flat = [r.flat() for r in records if r.ok]
    print(heatmap(flat, "micro_batch", "global_batch", "tokens_per_s"))
    assert all(r.ok for r in records), [r.error for r in records]
    return records


if __name__ == "__main__":
    main()
