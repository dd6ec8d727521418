"""Serving CLI of the port (``src/repro/launch/serve.py``): one
fixed-batch generation (``--mode batch``, the default), or
continuous-batching or fixed-policy service of synthetic Poisson load
over the slotted (default) or paged KV cache, with energy per token.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
      --mode batch --batch 4 --prompt-len 64 --gen 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --preset full --mode continuous --cache paged --slots 8 \\
      --requests 32 --rate 50

The defaults are the reference's: ``--arch gpt-117m``, ``--mode batch``
and ``--cache slotted``. Runs on the CUDA card by default (energy from
NVML's counter); ``--device cpu`` runs the plain PyTorch path with
synthetic power. ``--prefix-cache`` (paged only) has no counterpart in
the reference's launcher. The encdec and vlm families serve through
``--mode batch`` only, with the reference's stub side inputs: zero
encoder frames or patch embeddings in bf16.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.power.methods import NvmlEnergy, SyntheticPower
from repro_torch.serve.engine import BatchedServer, ServeEngine
from repro_torch.serve.requests import poisson_requests


def _run_batch(args, c, params, dev):
    server = BatchedServer(c, params, max_len=args.gen + 1, device=dev)
    prompts = torch.from_numpy(synthetic_tokens(
        args.batch, args.prompt_len, c.vocab, args.seed)[:, :args.prompt_len])
    extras = {}
    if c.family == "vlm":
        extras["patch_embeds"] = torch.zeros(
            (args.batch, c.n_patches, c.d_model), dtype=torch.bfloat16,
            device=dev)
    if c.family == "encdec":
        extras["enc_frames"] = torch.zeros(
            (args.batch, c.enc_seq, c.d_model), dtype=torch.bfloat16,
            device=dev)
    res = server.generate(prompts, args.gen, extras)
    print(f"[serve] arch={c.name} device={dev} batch={args.batch} "
          f"prefill={res.prefill_s * 1e3:.1f} ms "
          f"decode={res.decode_s * 1e3:.1f} ms "
          f"({res.decode_tokens_per_s:,.0f} tok/s decode)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-117m")
    ap.add_argument("--preset", choices=["full", "tiny"], default="tiny")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", choices=["batch", "continuous", "fixed"],
                    default="batch",
                    help="batch = one fixed-batch generate; continuous/"
                         "fixed = scheduled serving under Poisson load")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache", choices=["slotted", "paged"],
                    default="slotted",
                    help="KV layout: dense per-slot rows or the paged "
                         "block-table pool (serve.cache.PagedKVCache)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.rate <= 0:
        ap.error("--rate must be > 0 (Poisson arrival rate in req/s)")

    dev = resolve_device(args.device)
    c = get_config(args.arch)
    if args.preset == "tiny":
        c = c.reduced()
    params = lm.init(c, torch.Generator(device=dev).manual_seed(args.seed),
                     dev)
    if args.mode == "batch":
        return _run_batch(args, c, params, dev)
    if dev.type == "cuda":
        methods, source = [NvmlEnergy(dev.index or 0)], "nvml_energy"
    else:
        methods, source = [SyntheticPower()], "synthetic"
    max_len = args.prompt_len + args.gen + 1
    max_len = -(-max_len // args.block_size) * args.block_size
    engine = ServeEngine(c, params, n_slots=args.slots, max_len=max_len,
                         cache=args.cache, block_size=args.block_size,
                         prefix_cache=args.prefix_cache, device=dev,
                         power_methods=methods)
    engine.warmup(prompt_len=args.prompt_len)
    reqs = poisson_requests(args.requests, args.rate, c.vocab,
                            prompt_len=args.prompt_len, seed=args.seed,
                            short=(max(args.gen // 4, 1), args.gen),
                            long=(max(args.gen // 4, 1), args.gen))
    out = engine.serve(reqs, policy=args.mode)
    s = out.summary
    print(f"[serve] arch={c.name} device={dev} mode={args.mode} "
          f"slots={args.slots} rate={args.rate:g}/s power={source}")
    print(f"  {s.n_requests} requests, {s.n_tokens} tokens in "
          f"{s.wall_s:.2f} s -> {s.decode_tok_s:,.0f} tok/s "
          f"(cache={args.cache}, occupancy {s.mean_occupancy:.2f})")
    print(f"  ttft mean {s.mean_ttft_s * 1e3:.1f} ms / p95 "
          f"{s.p95_ttft_s * 1e3:.1f} ms")
    print(f"  energy {s.attributed_wh:.4f} Wh attributed "
          f"(+{s.overhead_wh:.4f} Wh overhead) -> "
          f"{s.wh_per_token * 1e3:.4f} mWh/token")
    return out


if __name__ == "__main__":
    main()
