"""Shared layers: norms, RoPE, MLP, embeddings, init helpers.

Port of ``src/repro/models/common.py``. Functions on tensors over
nested-dict parameter trees shaped like the reference's, with the same
weight layouts (``x @ w`` MLPs, ``(vocab, D)`` embedding tables) and the
same numerics: norms and RoPE in fp32 and cast back, split-half RoPE,
``gelu`` with the tanh approximation (JAX's default), and a padded-vocab
mask of ``finfo(float32).min``.
"""
from __future__ import annotations

import contextvars
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import layout as lay_mod

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
NEG_INF = torch.finfo(torch.float32).min


def recomputed(fn, *args, **kwargs):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant, no
    RNG state: no op of the port's layers draws random numbers), its
    recompute run in a copy of the forward's context, so that it sees the
    same context variables (the layout, the MoE dispatch): a CUDA
    backward runs on the autograd engine's device thread, which does not
    inherit them. ``kwargs`` go to ``checkpoint`` (``context_fn``)."""
    return checkpoint(_run_in, contextvars.copy_context(), fn, *args,
                      use_reentrant=False, preserve_rng_state=False,
                      **kwargs)


def _run_in(ctx: contextvars.Context, fn, *args):
    return ctx.copy().run(fn, *args)


def dtype_of(c: ModelConfig) -> torch.dtype:
    return _DTYPES[c.dtype]


def param_dtype_of(c: ModelConfig) -> torch.dtype:
    return _DTYPES[c.param_dtype]


# ---------------------------------------------------------------------------
# Initializers (the reference's distributions, drawn from a torch.Generator;
# ``lead`` prepends the layer-stack axes)
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def dense_init(gen, in_dim: int, out_shape, dtype, lead=()) -> torch.Tensor:
    """Fan-in variance scaling, as ``common.dense_init``."""
    out = tuple(out_shape) if isinstance(out_shape, tuple) else (out_shape,)
    return _normal(gen, (*lead, in_dim, *out), 1.0 / math.sqrt(in_dim), dtype)


def embed_init(gen, vocab: int, dim: int, dtype) -> torch.Tensor:
    return _normal(gen, (vocab, dim), 0.02, dtype)


def norm_init(c: ModelConfig, device, lead=()) -> Params:
    pd = param_dtype_of(c)
    p = {"scale": torch.ones((*lead, c.d_model), dtype=pd, device=device)}
    if c.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, c.d_model), dtype=pd, device=device)
    return p


def mlp_init(gen, c: ModelConfig, d_ff: int, lead=()) -> Params:
    pd = param_dtype_of(c)
    if c.act == "swiglu":
        p = {"wi_gate": dense_init(gen, c.d_model, d_ff, pd, lead),
             "wi_up": dense_init(gen, c.d_model, d_ff, pd, lead),
             "wo": dense_init(gen, d_ff, c.d_model, pd, lead)}
    else:
        p = {"wi": dense_init(gen, c.d_model, d_ff, pd, lead),
             "wo": dense_init(gen, d_ff, c.d_model, pd, lead)}
    if c.mlp_bias:
        p["bi"] = torch.zeros((*lead, d_ff), dtype=pd, device=gen.device)
        p["bo"] = torch.zeros((*lead, c.d_model), dtype=pd, device=gen.device)
    return p


def embedding_init(gen, c: ModelConfig) -> Params:
    pd = param_dtype_of(c)
    p = {"tok": embed_init(gen, c.padded_vocab, c.d_model, pd)}
    if not c.tie_embeddings:
        p["head"] = embed_init(gen, c.padded_vocab, c.d_model, pd)
    if not c.use_rope:
        p["pos"] = embed_init(gen, c.max_position, c.d_model, pd)
    return p


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def apply_norm(c: ModelConfig, p: Params, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if c.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    # torch.full fills on the device; a tensor literal would be a blocking
    # host-to-device copy that synchronises the stream in every layer
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions broadcastable to (..., S). Split-half
    rotation (not interleaved), angles in fp32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mlp(c: ModelConfig, p: Params, x: torch.Tensor,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The MLP. Under a layout (``parallel.layout``) whose ``wo`` holds
    fewer than ``d_ff`` rows, the rank's F-slice: Megatron's column- then
    row-parallel pair, ``f`` before and ``g`` after (``bo`` once, after;
    under sequence parallelism ``x`` (B, S, D) holds the rank's rows:
    ``Layout.enter`` / ``exit``, and an MLP every tp rank computes whole
    gathers them)."""
    lay = lay_mod.current()
    split = (lay is not None and lay.tp > 1 and d_ff is not None
             and p["wo"].shape[-2] < d_ff)
    if split:
        x = lay.enter(x)[0]
    else:
        x = lay_mod.whole_in(x)
    bi = p.get("bi")
    if split and bi is not None:
        bi = lay.local(lay.col(bi), -1)
    if c.act == "swiglu":
        g = x @ p["wi_gate"]
        u = x @ p["wi_up"]
        if bi is not None:
            g = g + bi
        h = F.silu(g) * u
    else:
        h = x @ p["wi"]
        if bi is not None:
            h = h + bi
        h = F.gelu(h, approximate="tanh")
    y = h @ p["wo"]
    if split:
        y = lay.exit(y)
        if "bo" in p:
            y = y + lay.on_rows(p["bo"])
        return y
    if "bo" in p:
        y = y + p["bo"]
    return lay_mod.whole_out(y)


def embed_tokens(c: ModelConfig, p: Params, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token (and learned position) embeddings. A ``tok`` table holding
    this rank's vocabulary rows (a layout's vocabulary split) embeds the
    ids in its range, zeros elsewhere, and the ranks' rows are summed."""
    lay = lay_mod.current()
    n = p["tok"].shape[0]
    if lay is not None and lay.tp > 1 and n < c.padded_vocab:
        ids = tokens.long() - lay.tp_rank * n
        inside = (ids >= 0) & (ids < n)
        x = p["tok"][ids.clamp(0, n - 1)] * inside[..., None].to(
            p["tok"].dtype)
        x = lay.row(x.to(dtype_of(c)))
    else:
        x = p["tok"][tokens].to(dtype_of(c))
    if not c.use_rope and positions is not None:
        x = x + p["pos"][positions].to(dtype_of(c))
    return x


def unembed(c: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits over the vocabulary; a table of this rank's vocabulary rows
    (a layout's split) gives this rank's logit columns."""
    table = p["tok"] if c.tie_embeddings else p["head"]
    lay = lay_mod.current()
    n, start = table.shape[0], 0
    if lay is not None and lay.tp > 1 and n < c.padded_vocab:
        x, start = lay.col(x), lay.tp_rank * n
    logits = torch.einsum("...d,vd->...v", x, table)
    if c.logits_softcap:
        logits = torch.tanh(logits / c.logits_softcap) * c.logits_softcap
    if c.padded_vocab != c.vocab:
        mask = torch.zeros(c.padded_vocab, dtype=logits.dtype,
                           device=logits.device)
        mask[c.vocab:] = NEG_INF
        logits = logits + mask[start:start + n]
    return logits
