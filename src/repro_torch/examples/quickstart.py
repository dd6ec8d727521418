"""Quickstart: the end-to-end example — train a GPT LM from scratch on
synthetic OSCAR-like data with the full pipeline (tokenizer -> indexed
dataset -> sharded loader -> train loop with checkpointing), measuring
throughput and energy CARAML-style.

Port of ``examples/quickstart.py``: its sizes, steps and assert (the
loss falls). The energy reading is the card's NVML energy counter on the
card; on the CPU the host's RAPL counters wrapped in ``FallbackPower``
(a labelled synthetic waveform where a read fails), or the labelled
synthetic waveform alone where the host has no readable RAPL zone.

  PYTHONPATH=src python -m repro_torch.examples.quickstart     # tiny
  PYTHONPATH=src python -m repro_torch.examples.quickstart --full-117m
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import pathlib
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data.indexed import IndexedDatasetReader, IndexedDatasetWriter
from repro_torch.data.loader import ShardedLoader, lm_sample_fn
from repro_torch.data.synthetic import synthetic_oscar_text
from repro_torch.data.tokenizer import ByteFallbackTokenizer
from repro_torch.device import resolve_device
from repro_torch.power.ctxmgr import get_power
from repro_torch.power.methods import (FallbackPower, NvmlEnergy, RaplPower,
                                       SyntheticPower)
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import (StepConfig, init_train_state,
                                    make_train_step)


def power_method(dev: torch.device):
    """The card's energy counter, or on the CPU the host's RAPL zones
    (falling back to a labelled synthetic waveform)."""
    if dev.type == "cuda":
        return NvmlEnergy(dev.index or 0)
    rapl = RaplPower()
    if rapl.available():
        return FallbackPower(rapl, SyntheticPower(len(rapl.devices())))
    return SyntheticPower()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-117m", action="store_true",
                    help="train the real GPT-117M for a few hundred steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.full_117m:
        c = get_config("gpt-117m")
        steps, gb, seq = args.steps or 300, 8, 256
    else:
        c = get_config("gpt-117m").reduced(d_model=128, n_layers=4, d_ff=512,
                                           n_heads=4, n_kv_heads=4, d_head=32,
                                           vocab=8192)
        steps, gb, seq = args.steps or 60, 8, 128

    print("== 1. data pipeline: synthetic OSCAR -> tokenizer -> "
          "indexed dataset")
    docs = synthetic_oscar_text(2000, seed=0)
    tok = ByteFallbackTokenizer.train(docs, max_vocab=c.vocab)
    with tempfile.TemporaryDirectory() as tmp:
        w = IndexedDatasetWriter(pathlib.Path(tmp) / "oscar")
        for d in docs:
            w.add_document(tok.encode(d))
        w.finalize(meta={"tokenizer": "byte-fallback", "docs": len(docs)})
        reader = IndexedDatasetReader(pathlib.Path(tmp) / "oscar")
        print(f"   {reader.n_documents} docs, {reader.n_tokens:,} tokens")

        print(f"== 2. model: {c.name} ({c.param_count() / 1e6:.1f}M params)"
              f" on {dev}")
        oc = OptConfig(lr=3e-4, warmup=max(steps // 20, 5), total_steps=steps)
        params, opt_state = init_train_state(
            c, oc, torch.Generator(device=dev).manual_seed(0), dev)
        step = make_train_step(c, oc, StepConfig())
        loader = ShardedLoader(lm_sample_fn(reader, seq), gb)

        def batches():
            for b in loader:
                yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

        print(f"== 3. train {steps} steps (batch {gb} x seq {seq}) with "
              f"energy measurement")
        power = power_method(dev)
        cfg = LoopConfig(total_steps=steps, ckpt_every=max(steps // 2, 10),
                         ckpt_dir=str(pathlib.Path(tmp) / "ckpt"),
                         log_every=max(steps // 6, 5), seq_len=seq,
                         global_batch=gb)
        try:
            with get_power([power], interval_ms=100) as scope:
                res = train_loop(step, params, opt_state, batches(), cfg)
        finally:
            loader.close()
    wh = scope.total_energy_wh()
    n_tok = res.steps_run * gb * seq
    print("\n== results ==")
    print(f"loss: {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"(decreased: {res.losses[-1] < res.losses[0]})")
    print(f"throughput: {res.tokens_per_s:,.0f} tokens/s")
    print(f"energy: {wh:.4f} Wh ({getattr(power, 'label', power.name)}) -> "
          f"{n_tok / wh if wh else 0:,.0f} tokens/Wh")
    assert res.losses[-1] < res.losses[0], "training must reduce loss"
    return res


if __name__ == "__main__":
    main()
