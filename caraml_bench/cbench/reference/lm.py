"""Plain reference of the decoder-only model: loss and gradients.

Written from the model's description, not from the program: token
embedding; per layer pre-LayerNorm (eps 1e-5), Q, K, V projections with
biases, rotary positions (split-half, theta from the configuration,
angles in float32), causal softmax attention scaled by 1/sqrt(Dh), the
output projection, a residual; pre-LayerNorm, the GELU MLP (tanh form)
with biases, a residual; the final LayerNorm; logits against the tied
embedding over the vocabulary; the next-token cross-entropy, its mean
over every token of the step. Computed in blocks of rows (their losses
and gradients summed, each over the step's token count), each layer
recomputed in the backward, so that the step fits beside nothing else.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cbench.reference.lowp import Precision

TOKENS_PER_BLOCK = 8192


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (r, s, h, dh); rotate the two halves of each head."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(cfg, P, i, x, prec: Precision):
    r, s, D = x.shape
    H, Kh = cfg["n_heads"], cfg["n_kv_heads"]
    Dh = cfg.get("d_head") or D // H
    pre = "layers.slot0."

    def w(name):
        return P[pre + name][i]

    def norm(t, n):
        return F.layer_norm(t, (D,), w(n + ".scale"), w(n + ".bias"), 1e-5)

    h = norm(x, "norm1")
    q = prec.mm(h, w("attn.wq").reshape(D, H * Dh)) + w("attn.bq").reshape(-1)
    k = prec.mm(h, w("attn.wk").reshape(D, Kh * Dh)) + w("attn.bk").reshape(-1)
    v = prec.mm(h, w("attn.wv").reshape(D, Kh * Dh)) + w("attn.bv").reshape(-1)
    q = _rope(q.view(r, s, H, Dh), cfg["rope_theta"])
    k = _rope(k.view(r, s, Kh, Dh), cfg["rope_theta"])
    v = v.view(r, s, Kh, Dh)
    if Kh != H:
        k = k.repeat_interleave(H // Kh, dim=2)
        v = v.repeat_interleave(H // Kh, dim=2)
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))    # (r, H, s, Dh)
    scores = prec.mm(q / math.sqrt(Dh), k.transpose(-1, -2))
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = prec.mm(att, v).permute(0, 2, 1, 3).reshape(r, s, H * Dh)
    x = x + prec.mm(o, w("attn.wo").reshape(H * Dh, D))
    h = norm(x, "norm2")
    u = F.gelu(prec.mm(h, w("mlp.wi")) + w("mlp.bi"), approximate="tanh")
    return x + prec.mm(u, w("mlp.wo")) + w("mlp.bo")


def block_loss_sum(cfg, P, tokens, labels, prec: Precision,
                   remat: bool = True) -> torch.Tensor:
    """The summed next-token losses of rows ``tokens`` -> ``labels``."""
    if (cfg["norm"], cfg["act"], cfg["qkv_bias"], cfg["mlp_bias"],
            cfg["use_rope"], cfg["tie_embeddings"]) != (
            "layernorm", "gelu", True, True, True, True):
        raise ValueError("this reference is the GPT decoder: LayerNorm, "
                         "GELU, biases, RoPE, tied embeddings")
    V, D = cfg["vocab"], cfg["d_model"]
    table = P["embed.tok"]
    x = table[tokens.long()]
    for i in range(cfg["n_layers"]):
        if remat:
            x = checkpoint(_layer, cfg, P, i, x, prec, use_reentrant=False)
        else:
            x = _layer(cfg, P, i, x, prec)
    x = F.layer_norm(x, (D,), P["final_norm.scale"], P["final_norm.bias"],
                     1e-5)
    logits = prec.mm(x, table[:V].T)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - picked).sum()


def loss_and_grads(cfg, P: dict, batch: dict, prec: Precision,
                   remat: bool = True):
    """``(mean loss, {name: gradient})`` of one step's batch."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in P.items()}
    names = list(leaves)
    tokens, labels = batch["tokens"], batch["labels"]
    n_tok = tokens.numel()
    rows = max(1, TOKENS_PER_BLOCK // tokens.shape[1])
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
    for r0 in range(0, tokens.shape[0], rows):
        with torch.enable_grad():
            loss = block_loss_sum(cfg, leaves, tokens[r0:r0 + rows],
                                  labels[r0:r0 + rows], prec, remat) / n_tok
            gs = torch.autograd.grad(loss, [leaves[n] for n in names],
                                     allow_unused=True)
        for n, g in zip(names, gs):
            if g is not None:
                grads[n] += g
        total += loss.detach()
    return total, grads
