"""Batched serving example: prefill + greedy decode with KV (and SSM
state) caches, across three architecture families (dense GQA, SSM, MoE)
through ``BatchedServer``, end to end.

Port of ``examples/serve_decode.py``: its archs (reduced), prompts,
budgets and asserts.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode
  PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import BatchedServer

ARCHS = ("llama3.2-3b", "mamba2-1.3b", "granite-moe-3b-a800m")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    for arch in ARCHS:
        c = get_config(arch).reduced()
        params = lm.init(c, torch.Generator(device=dev).manual_seed(0), dev)
        server = BatchedServer(c, params, max_len=24, device=dev)
        prompts = torch.from_numpy(
            synthetic_tokens(4, 32, c.vocab)[:, :32]).to(dev)
        res = server.generate(prompts, 16)
        assert tuple(res.tokens.shape) == (4, 16)
        assert bool((res.tokens >= 0).all())
        print(f"{arch:24s} prefill {res.prefill_s * 1e3:7.1f} ms | "
              f"decode {res.decode_s * 1e3:7.1f} ms | "
              f"{res.decode_tokens_per_s:8,.0f} tok/s | "
              f"sample: {res.tokens[0, :8].tolist()}")
        out[arch] = res
    return out


if __name__ == "__main__":
    main()
