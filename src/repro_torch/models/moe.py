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

Under a layout (``parallel.layout``) the layer computes what the
reference's one global program computes:

  * **Global ranking.** The capacity ``C`` comes from the microbatch's
    global token count, and each (token, choice) pair's position within
    its expert is offset by the pairs that the lower batch ranks route
    there (one ``all_gather`` of ``E`` counts a layer: the global order
    is rank-major, since a rank's rows are a contiguous block), so the
    same pairs are dropped. A rank's dispatch buffer holds its own pairs
    only, ``min(C, T * k)`` rows an expert.
  * **Global load balance.** The aux loss's ``me`` and ``ce`` are built
    from sums all-reduced over the batch ranks (identity backward).
  * **Experts split over ``model``.** With expert parallelism the rank
    holds ``E / tp`` experts: every tp rank routes the same tokens (the
    router is replicated), fills only its experts' rows and the combine
    is all-reduced (Megatron's ``g``); without it each expert's F is
    split, as the MLP's.
  * **The dispatch buffer's D over ``model``** (a layout's
    ``moe_dshard``, with expert parallelism; the reference's
    ``buf_spec=P(None, tp)``): each tp rank fills the ``(E * C + 1, D /
    tp)`` buffer of every expert from its D-columns of the tokens, an
    all-to-all brings its experts' rows whole to it ``(E / tp, C, D)``,
    a second one sends their outputs back, and the rank combines its
    columns ``(T, D / tp)``, all-gathered to ``(T, D)`` in the place of
    the combine's all-reduce.
  * **Sequence parallelism.** The input holds the rank's rows of the
    sequence: the split compute's input and output pass
    ``Layout.enter`` / ``exit``; the router reads the gathered rows
    through ``enter``'s whole view; a layer every tp rank computes whole
    (no split, or the D-cut dispatch, which all-gathers its output)
    gathers the rows and cuts its output.
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
from repro_torch.parallel import layout as lay_mod

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
    lay = lay_mod.current()
    if lay is not None and lay.batch_size > 1:
        # means over the microbatch's global tokens
        n = x2d.shape[0] * lay.batch_size
        me = lay.batch_sum(probs.sum(dim=0)) / n
        ce = lay.batch_sum(F.one_hot(experts[:, 0], c.n_experts).float()
                           .sum(dim=0)) / n
    else:
        me = probs.mean(dim=0)                                  # (E,)
        ce = F.one_hot(experts[:, 0], c.n_experts).float().mean(dim=0)
    aux = c.n_experts * torch.sum(me * ce)
    return weights, experts, aux


def expert_capacity(c: ModelConfig, n_tokens: int) -> int:
    cap = int(math.ceil(n_tokens * c.top_k * c.capacity_factor / c.n_experts))
    return max(cap, 4)


def _split(c: ModelConfig, experts: Params):
    """``(layout, "ep" | "f" | None)``: how the current layout splits the
    experts over ``model`` (by the leaves' shapes)."""
    lay = lay_mod.current()
    if lay is None or lay.tp == 1:
        return lay, None
    if experts["wo"].shape[-3] < c.n_experts:
        return lay, "ep"
    if experts["wo"].shape[-2] < (c.expert_d_ff or c.d_ff):
        return lay, "f"
    return lay, None


def _expert_biases(lay, split, experts: Params):
    """``(bi, bo)`` as this rank's split compute uses them: an F-split
    cuts the replicated ``bi`` to the rank's columns and adds ``bo`` on
    tp rank 0 only (the combine sums the ranks)."""
    bi, bo = experts.get("bi"), experts.get("bo")
    if split == "f":
        if bi is not None:
            bi = lay.local(lay.col(bi), -1)
        if bo is not None:
            bo = lay.col(bo) * float(lay.tp_rank == 0)
    return bi, bo


def _apply_experts(c: ModelConfig, experts: Params,
                   buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, D) -> (E, C, D) through each expert's MLP (batched)."""
    lay, split = _split(c, experts)
    bi, bo = _expert_biases(lay, split, experts)
    if c.act == "swiglu":
        g = torch.einsum("ecd,edf->ecf", buf, experts["wi_gate"])
        u = torch.einsum("ecd,edf->ecf", buf, experts["wi_up"])
        h = F.silu(g) * u
    else:
        h = torch.einsum("ecd,edf->ecf", buf, experts["wi"])
        if bi is not None:
            h = h + bi[:, None]
        h = F.gelu(h, approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, experts["wo"])
    if bo is not None:
        out = out + bo[:, None]
    return out


def _input(lay, split, dshard: bool, x: torch.Tensor):
    """``(xc, x, whole)``: the layer's input for the split compute and
    for the router (``Layout.enter``), and whether every tp rank
    computes the layer whole (no split, or the D-cut dispatch):
    ``whole_in`` then gathers a sequence-parallel input."""
    if split is None or dshard:
        x = lay_mod.whole_in(x)
        return x, x, True
    return (*lay.enter(x), False)


def _output(lay, whole: bool, y: torch.Tensor) -> torch.Tensor:
    """The layer's (B, S, D) output: the split compute's partial sums
    made whole (``Layout.exit``), or the rank's rows of a whole one."""
    if whole:
        return lay_mod.whole_out(y)
    return lay.exit(y)


def _dshard_combine(c: ModelConfig, lay, experts: Params, x2d, dest, cap,
                    wk) -> torch.Tensor:
    """The dispatch with the buffer's D cut over ``model``: this rank's
    columns of every (token, choice) pair placed at ``dest`` of an
    ``(E * cap + 1, D / tp)`` buffer, the rows moved to their experts'
    ranks and back by two all-to-alls, combined by ``wk`` and
    all-gathered to ``(T, D)`` (every tp rank then holds the same
    output, so the gather's backward takes the rank's columns)."""
    E, k = c.n_experts, c.top_k
    T, d = x2d.shape
    if d % lay.tp:
        raise ValueError(f"moe_dshard: d_model {d} does not split over "
                         f"{lay.tp} ranks")
    dc = d // lay.tp
    xd = lay.cut(x2d, 1)       # its columns; the gradient all-gathered
    buf = xd.new_zeros((E * cap + 1, dc)).index_add(
        0, dest, xd.repeat_interleave(k, dim=0))
    buf = lay.all_to_all(buf[:-1].reshape(E, cap, dc), 0, 2)
    out = _apply_experts(c, experts, buf)               # (E / tp, cap, D)
    out = lay.all_to_all(out, 2, 0).reshape(E * cap, dc)
    out = torch.cat([out, out.new_zeros((1, dc))])
    y = (out[dest] * wk).reshape(T, k, dc).sum(dim=1)
    return lay.gather_whole(y, 1)


def moe_forward(c: ModelConfig, p: Params, x: torch.Tensor):
    """x: (B, S, D) -> (y (B, S, D), aux_loss). Pairs past an expert's
    capacity (``expert_capacity`` of all B * S rows, pad and idle rows
    included) contribute nothing."""
    if _MOE_IMPL.get() == "dense":
        return moe_forward_einsum(c, p, x)
    lay, split = _split(c, p["experts"])
    dshard = split == "ep" and lay.moe_dshard
    xs = x                                      # the rows this rank holds
    xc, x, whole = _input(lay, split, dshard, x)
    b, s, d = x.shape
    T, k, E = b * s, c.top_k, c.n_experts
    x2d = x.reshape(T, d)
    weights, experts_idx, aux = router_topk(c, p, x2d)
    nb = 1 if lay is None else lay.batch_size

    # position of each (token, choice) within its expert, by cumsum ranking
    sel_flat = F.one_hot(experts_idx, E).reshape(T * k, E)
    pos = torch.cumsum(sel_flat, dim=0) * sel_flat - 1          # (T*k, E)
    pos_in_expert = pos.amax(dim=-1)                            # (T*k,)
    eidx = experts_idx.reshape(-1)
    if nb > 1:
        # the global ranking: after the lower batch ranks' pairs
        counts = lay.batch_gather(sel_flat.sum(dim=0))          # (nb, E)
        below = counts[:lay.batch_index].sum(dim=0)
        C = expert_capacity(c, T * nb)
        keep = (pos_in_expert >= 0) & (pos_in_expert + below[eidx] < C)
        cap = min(C, T * k)
    else:
        C = cap = expert_capacity(c, T)
        keep = (pos_in_expert >= 0) & (pos_in_expert < C)
    w = weights if split is None else lay.col(weights)
    wk = (w.reshape(-1, 1) * keep[:, None]).to(x.dtype)
    e_loc, here = eidx, keep
    n_loc = E if dshard else p["experts"]["wo"].shape[-3]
    if split == "ep" and not dshard:        # this rank's experts only
        e_loc = eidx - lay.tp_rank * n_loc
        here = keep & (e_loc >= 0) & (e_loc < n_loc)
    dest = e_loc * cap + pos_in_expert.clamp(0, cap - 1)
    dest = torch.where(here, dest, torch.full_like(dest, n_loc * cap))

    if dshard:
        y = _dshard_combine(c, lay, p["experts"], x2d, dest, cap, wk)
    else:
        xk = xc.reshape(T, d).repeat_interleave(k, dim=0)       # (T*k, D)
        buf = x.new_zeros((n_loc * cap + 1, d)).index_add(0, dest, xk)
        buf = buf[:-1].reshape(n_loc, cap, d)
        out_buf = _apply_experts(c, p["experts"], buf).reshape(n_loc * cap,
                                                               d)
        out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])
        y = (out_buf[dest] * wk).reshape(T, k, d).sum(dim=1)    # (T, D)
    y = _output(lay, whole, y.reshape(b, s, d))
    if c.moe_shared:
        y = y + apply_mlp(c, p["shared"], xs, c.expert_d_ff or c.d_ff)
    return y, aux


def moe_forward_einsum(c: ModelConfig, p: Params, x: torch.Tensor):
    """Masked batched-einsum MoE: all experts on all tokens, no drops."""
    ex = p["experts"]
    lay, split = _split(c, ex)
    xs = x
    xc, x, whole = _input(lay, split, False, x)
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    weights, experts_idx, aux = router_topk(c, p, x2d)
    # dense (T, E) weight matrix with zeros for unrouted experts
    wfull = torch.zeros((b * s, c.n_experts), dtype=torch.float32,
                        device=x.device).scatter(1, experts_idx, weights)
    xin = xc.reshape(b * s, d)
    if split is not None:
        wfull = lay.col(wfull)
        if split == "ep":
            wfull = lay.local(wfull, 1)
    bi, bo = _expert_biases(lay, split, ex)
    if c.act == "swiglu":
        g = torch.einsum("td,edf->tef", xin, ex["wi_gate"])
        u = torch.einsum("td,edf->tef", xin, ex["wi_up"])
        h = F.silu(g) * u
    else:
        h = torch.einsum("td,edf->tef", xin, ex["wi"])
        if bi is not None:
            h = h + bi[None]
        h = F.gelu(h, approximate="tanh")
    wh = wfull.to(h.dtype)
    y = torch.einsum("tef,efd->td", h * wh[..., None], ex["wo"])
    if bo is not None:
        y = y + torch.einsum("te,ed->td", wh, bo)
    y = _output(lay, whole, y.reshape(b, s, d))
    if c.moe_shared:
        y = y + apply_mlp(c, p["shared"], xs, c.expert_d_ff or c.d_ff)
    return y, aux


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
