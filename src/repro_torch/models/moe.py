"""Mixture-of-Experts FFN: top-k router + capacity-based scatter dispatch.

Port of ``src/repro/models/moe.py``. Dispatch ranks each (token, choice)
pair within its expert by a cumsum over the ``(T * k, E)`` one-hot in
token-major order, drops pairs past the expert's capacity ``C`` to an
overflow row, and scatters the kept ones into an ``(E * C + 1, D)``
buffer with ``index_add`` (the reference's ``.at[dest].add``): every
destination but the discarded overflow row is unique, so the buffer is
deterministic on the card too. ``moe_forward_einsum`` (all experts on all
tokens, no drops; selected by ``moe_impl("dense")``) and
``moe_forward_dense`` (the oracle: a loop over experts) are ported too.

The router runs in fp32: an fp32 parameter against the fp32 tokens.
``torch.topk`` and ``jax.lax.top_k`` may order exact ties differently;
random weights make ties measure-zero.

The reference's ``_MOE_BUF_SPEC`` / ``_buf_hint`` is a sharding
constraint on the dispatch buffer; on one device it is a no-op, so it is
left out (``moe_impl`` takes no ``buf_spec``).
"""
from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import apply_mlp, dense_init, mlp_init

Params = Any

#: dispatch implementation: "scatter" (capacity-based, the default) or
#: "dense" (masked batched einsum over all experts, no drops)
_MOE_IMPL: ContextVar[str] = ContextVar("moe_impl", default="scatter")


@contextlib.contextmanager
def moe_impl(name: str):
    """Select the dispatch of every ``moe_forward`` inside the block."""
    if name not in ("scatter", "dense"):
        raise ValueError(f"moe impl {name!r}: scatter or dense")
    tok = _MOE_IMPL.set(name)
    try:
        yield
    finally:
        _MOE_IMPL.reset(tok)


def moe_init(gen, c: ModelConfig, lead=()) -> Params:
    """Experts stacked on an ``E`` axis after ``lead``; an fp32 router."""
    eff = c.expert_d_ff or c.d_ff
    p = {
        "router": dense_init(gen, c.d_model, c.n_experts, torch.float32, lead),
        "experts": mlp_init(gen, c, eff, (*lead, c.n_experts)),
    }
    if c.moe_shared:
        p["shared"] = mlp_init(gen, c, eff, lead)
    return p


def router_topk(c: ModelConfig, p: Params, x2d: torch.Tensor):
    """x2d: (T, D) -> (weights (T, k), experts (T, k), aux_loss scalar)."""
    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    weights, experts = torch.topk(probs, c.top_k, dim=-1)       # (T, k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing auxiliary loss
    me = probs.mean(dim=0)                                      # (E,)
    ce = F.one_hot(experts[:, 0], c.n_experts).float().mean(dim=0)
    aux = c.n_experts * torch.sum(me * ce)
    return weights, experts, aux


def expert_capacity(c: ModelConfig, n_tokens: int) -> int:
    cap = int(math.ceil(n_tokens * c.top_k * c.capacity_factor / c.n_experts))
    return max(cap, 4)


def _apply_experts(c: ModelConfig, experts: Params,
                   buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, D) -> (E, C, D) through each expert's MLP (batched)."""
    if c.act == "swiglu":
        g = torch.einsum("ecd,edf->ecf", buf, experts["wi_gate"])
        u = torch.einsum("ecd,edf->ecf", buf, experts["wi_up"])
        h = F.silu(g) * u
    else:
        h = torch.einsum("ecd,edf->ecf", buf, experts["wi"])
        if "bi" in experts:
            h = h + experts["bi"][:, None]
        h = F.gelu(h, approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, experts["wo"])
    if "bo" in experts:
        out = out + experts["bo"][:, None]
    return out


def moe_forward(c: ModelConfig, p: Params, x: torch.Tensor):
    """x: (B, S, D) -> (y (B, S, D), aux_loss). Pairs past an expert's
    capacity (``expert_capacity`` of all B * S rows, pad and idle rows
    included) contribute nothing."""
    if _MOE_IMPL.get() == "dense":
        return moe_forward_einsum(c, p, x)
    b, s, d = x.shape
    T, k, E = b * s, c.top_k, c.n_experts
    x2d = x.reshape(T, d)
    weights, experts_idx, aux = router_topk(c, p, x2d)
    C = expert_capacity(c, T)

    # position of each (token, choice) within its expert, by cumsum ranking
    sel_flat = F.one_hot(experts_idx, E).reshape(T * k, E)
    pos = torch.cumsum(sel_flat, dim=0) * sel_flat - 1          # (T*k, E)
    pos_in_expert = pos.amax(dim=-1)                            # (T*k,)
    keep = (pos_in_expert >= 0) & (pos_in_expert < C)
    dest = experts_idx.reshape(-1) * C + pos_in_expert.clamp(0, C - 1)
    dest = torch.where(keep, dest, torch.full_like(dest, E * C))  # overflow

    xk = x2d.repeat_interleave(k, dim=0)                        # (T*k, D)
    buf = x.new_zeros((E * C + 1, d)).index_add(0, dest, xk)
    buf = buf[:-1].reshape(E, C, d)

    out_buf = _apply_experts(c, p["experts"], buf).reshape(E * C, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])

    gathered = out_buf[dest]                                    # (T*k, D)
    wk = (weights.reshape(-1, 1) * keep[:, None]).to(x.dtype)
    y = (gathered * wk).reshape(T, k, d).sum(dim=1)

    if c.moe_shared:
        y = y + apply_mlp(c, p["shared"], x2d)
    return y.reshape(b, s, d), aux


def moe_forward_einsum(c: ModelConfig, p: Params, x: torch.Tensor):
    """Masked batched-einsum MoE: all experts on all tokens, no drops."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    weights, experts_idx, aux = router_topk(c, p, x2d)
    # dense (T, E) weight matrix with zeros for unrouted experts
    wfull = torch.zeros((b * s, c.n_experts), dtype=torch.float32,
                        device=x.device).scatter(1, experts_idx, weights)
    ex = p["experts"]
    if c.act == "swiglu":
        g = torch.einsum("td,edf->tef", x2d, ex["wi_gate"])
        u = torch.einsum("td,edf->tef", x2d, ex["wi_up"])
        h = F.silu(g) * u
    else:
        h = torch.einsum("td,edf->tef", x2d, ex["wi"])
        if "bi" in ex:
            h = h + ex["bi"][None]
        h = F.gelu(h, approximate="tanh")
    wh = wfull.to(h.dtype)
    y = torch.einsum("tef,efd->td", h * wh[..., None], ex["wo"])
    if "bo" in ex:
        y = y + torch.einsum("te,ed->td", wh, ex["bo"])
    if c.moe_shared:
        y = y + apply_mlp(c, p["shared"], x2d)
    return y.reshape(b, s, d), aux


def moe_forward_dense(c: ModelConfig, p: Params, x: torch.Tensor):
    """Oracle: loop over experts with dense masks (no capacity drops)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    weights, experts_idx, aux = router_topk(c, p, x2d)
    y = torch.zeros_like(x2d)
    for e in range(c.n_experts):
        pe = {name: w[e] for name, w in p["experts"].items()}
        ye = apply_mlp(c, pe, x2d)
        w_e = torch.where(experts_idx == e, weights,
                          torch.zeros_like(weights)).sum(-1)    # (T,)
        y = y + ye * w_e[:, None].to(x.dtype)
    if c.moe_shared:
        y = y + apply_mlp(c, p["shared"], x2d)
    return y.reshape(b, s, d), aux
