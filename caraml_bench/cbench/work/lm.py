"""The matrix-product work of a decoder-only step.

Per microbatch of ``r`` rows of ``s`` tokens (``m = r s``) and per
layer: the Q, K, V and output projections, the MLP's two products,
and attention as one fused product (QK and PV): ``4 d`` operations for
each visible (query, key) pair, which under the causal mask are the
``s (s + 1) / 2`` pairs of a row (``causal=False``: all ``s^2``), its
least bytes Q, K, V read and O written forward, and Q, K, V, O, dO read
and dQ, dK, dV written backward, at twice the forward's operations.
Then the tied logits over the vocabulary (unpadded: padding is not
needed work). Every product's input needs a gradient (the embedding
feeds the first layer), so each is counted three times.
"""
from __future__ import annotations

from cbench.work import Op, matmul


def step_ops(cfg: dict, traffic: dict, causal: bool = True,
             width: int = 2) -> list:
    k = int(traffic.get("microbatches", 1))
    r = int(traffic["global_batch"]) // k
    s = int(traffic["seq_len"])
    m = r * s
    D, F, L = cfg["d_model"], cfg["d_ff"], cfg["n_layers"]
    H, Kh = cfg["n_heads"], cfg["n_kv_heads"]
    Dh = cfg.get("d_head") or D // H
    n = k * L
    pairs = r * (s * (s + 1) // 2 if causal else s * s)
    qkv = r * s * Dh * (2 * H + 2 * Kh)        # Q, K, V read; O written
    return [
        matmul("q_proj", m, D, H * Dh, count=n, width=width),
        matmul("kv_proj", m, D, 2 * Kh * Dh, count=n, width=width),
        matmul("o_proj", m, H * Dh, D, count=n, width=width),
        matmul("mlp_in", m, D, F, count=n, width=width),
        matmul("mlp_out", m, F, D, count=n, width=width),
        Op("attention", 3 * 4.0 * H * Dh * pairs, 3.0 * width * qkv, n),
        matmul("logits", m, D, cfg["vocab"], count=k, width=width),
    ]
