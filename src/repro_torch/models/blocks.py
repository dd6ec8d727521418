"""Decoder blocks over period-stacked parameters.

Port of ``src/repro/models/blocks.py`` (``period_of``, ``slot_kinds``,
``stack_init``, ``enc_stack_init``, ``stack_forward``, ``stack_prefill``
and ``stack_decode``). Heterogeneous layer patterns (Jamba's one attention
layer in eight, llama4's MoE on every second layer) are one *period* of
slots, ``{"slot0": ..., "slot{period-1}": ...}``, with every leaf stacked
over ``n_periods = n_layers // period``: the reference's tree. A dense
stack has a period of one layer, so its tree is ``{"slot0": {...}}``
with leading axis ``n_layers``. Each slot's mixer is ``attn`` or
``mamba``, its FFN ``mlp``, ``moe`` or none. An encdec decoder's slots
also hold ``norm_x`` and a ``cross`` attention, applied after the mixer
and before the FFN against the encoder's K/V (``enc_kv``: per period
``{"slot{i}": {"k", "v"}}``, each leaf stacked over the periods like the
params); the encoder's own stack (``enc_stack_init``) has no ``slot{i}``
level.

The reference scans over the periods; here a Python loop walks periods
and slots. The training forward unbinds each stacked leaf once, so the
backward stacks each leaf's gradient once (as the reference's scan
writes one slice per period) instead of adding one zero-padded
full-stack gradient per layer. Caches stay stacked per slot: attention
slots hold paged pools ``(n_periods, n_blocks, bs, Kh, Dh)`` (int8 pools
with ``(n_periods, n_blocks, Kh)`` scale leaves beside them) or dense
slotted rows ``(n_periods, B, T, Kh, Dh)``; mamba slots hold per-row
``{"ssm", "conv"}`` state in either layout. Decode updates them in place.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_mlp, apply_norm, mlp_init, norm_init

Params = Any

#: matmuls whose outputs ``remat="dots"`` saves; ``torch.einsum`` lowers
#: every contraction to ``bmm``, a contraction without batch dimensions
#: to a ``bmm`` of batch 1
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BMM = torch.ops.aten.bmm.default


def period_of(c: ModelConfig) -> int:
    """Layers in one period of the layer pattern."""
    p = 1
    if c.family == "hybrid":
        p = c.attn_layer_period
    if c.n_experts:
        p = max(p, c.moe_layer_step)
        if p % c.moe_layer_step:
            raise ValueError(f"{c.name}: incompatible layer pattern")
    if c.n_layers % p:
        raise ValueError(f"{c.name}: {c.n_layers} layers are not whole "
                         f"periods of {p}")
    return p


def slot_kinds(c: ModelConfig) -> list[tuple[str, Optional[str]]]:
    """Per-slot (mixer, ffn) kinds for one period of the layer pattern."""
    kinds = []
    for i in range(period_of(c)):
        mixer = "attn" if c.is_attn_layer(i) else "mamba"
        if c.family == "ssm":
            ffn = None
        elif c.is_moe_layer(i):
            ffn = "moe"
        elif c.d_ff:
            ffn = "mlp"
        else:
            ffn = None
        kinds.append((mixer, ffn))
    return kinds


def attn_layers(c: ModelConfig) -> int:
    """Attention layers in the whole stack (each runs one paged kernel
    call per decode step or paged prefill)."""
    n_periods = c.n_layers // period_of(c)
    return n_periods * sum(m == "attn" for m, _f in slot_kinds(c))


def layer(tree: Params, i: int) -> Params:
    """Period ``i``'s view of a stacked tree (leaves indexed, no copy)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def _n_periods(slot_tree: Params) -> int:
    return slot_tree["norm1"]["scale"].shape[0]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _slot_init(gen, c: ModelConfig, mixer: str, ffn: Optional[str],
               lead, cross: bool = False) -> Params:
    dev = gen.device
    p: dict = {"norm1": norm_init(c, dev, lead)}
    if mixer == "attn":
        p["attn"] = attn.attn_init(gen, c, lead)
    else:
        p["mamba"] = ssm_mod.mamba_init(gen, c, lead)
    if cross:
        p["norm_x"] = norm_init(c, dev, lead)
        p["cross"] = attn.attn_init(gen, c, lead)
    if ffn == "mlp":
        p["norm2"] = norm_init(c, dev, lead)
        p["mlp"] = mlp_init(gen, c, c.d_ff, lead)
    elif ffn == "moe":
        p["norm2"] = norm_init(c, dev, lead)
        p["moe"] = moe_mod.moe_init(gen, c, lead)
    return p


def stack_init(gen, c: ModelConfig, cross: bool = False) -> Params:
    """Stacked layer params: every leaf's leading axis is n_periods;
    ``cross`` adds ``norm_x`` and a ``cross`` attention to every slot."""
    lead = (c.n_layers // period_of(c),)
    return {f"slot{i}": _slot_init(gen, c, mixer, ffn, lead, cross=cross)
            for i, (mixer, ffn) in enumerate(slot_kinds(c))}


def enc_stack_init(gen, c: ModelConfig) -> Params:
    """Encoder stack (bidirectional attention + MLP): every leaf stacked
    over ``n_enc_layers``, no ``slot{i}`` level."""
    return _slot_init(gen, c, "attn", "mlp", (c.n_enc_layers,))


# ---------------------------------------------------------------------------
# Forward (training / full sequence)
# ---------------------------------------------------------------------------


def _ffn(c: ModelConfig, sp: Params, x: torch.Tensor, ffn: Optional[str]):
    """The slot's FFN residual; returns (x, MoE aux loss or None)."""
    if ffn == "mlp":
        return x + apply_mlp(c, sp["mlp"], apply_norm(c, sp["norm2"], x)), None
    if ffn == "moe":
        y, aux = moe_mod.moe_forward(c, sp["moe"],
                                     apply_norm(c, sp["norm2"], x))
        return x + y, aux
    return x, None


def _unstack(tree: Params, n: int) -> list:
    """Per-period trees of views, from one ``unbind`` per stacked leaf."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _cross(c: ModelConfig, sp: Params, x: torch.Tensor, ekv,
           impl: str = "repeat") -> torch.Tensor:
    """The slot's cross-attention residual (none without ``ekv``)."""
    if ekv is None:
        return x
    h = apply_norm(c, sp["norm_x"], x)
    return x + attn.cross_attention(c, sp["cross"], h, (ekv["k"], ekv["v"]),
                                    impl)


def _slot_forward(c: ModelConfig, sp: Params, x: torch.Tensor, causal: bool,
                  mixer: str, ffn: Optional[str], ekv, impl: str):
    h = apply_norm(c, sp["norm1"], x)
    if mixer == "attn":
        h = attn.self_attention(c, sp["attn"], h, causal=causal, impl=impl)
    else:
        h = ssm_mod.mamba_forward(c, sp["mamba"], h)
    x, aux = _ffn(c, sp, _cross(c, sp, x + h, ekv, impl), ffn)
    return x, torch.zeros((), dtype=torch.float32, device=x.device) \
        if aux is None else aux


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``:
    save the outputs of matmuls without batch dimensions (``mm``,
    ``addmm``, a ``bmm`` of batch 1), recompute everything else."""
    if op in _MATMULS or (op is _BMM and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(
        lambda ctx, op, *a, **k: _dots_policy(ctx, op, *a, **k))


def stack_forward(c: ModelConfig, layers: Params, x: torch.Tensor, *,
                  causal: bool = True, impl: str = "repeat",
                  remat: str = "full", enc_kv: Params = None):
    """Run the full layer stack, no caches. x: (B, S, D) -> (B, S, D),
    aux_loss (summed over the MoE slots). ``remat="full"`` recomputes
    each layer in the backward (``torch.utils.checkpoint``), saving only
    the layer inputs; ``"dots"`` saves the layer's matmul outputs and
    recomputes the rest (selective checkpointing, :func:`_dots_policy`);
    ``"none"`` keeps every activation. ``impl`` is ``sdpa``'s
    formulation. ``enc_kv``: the encoder's K/V for the cross slots
    (encdec)."""
    if remat not in ("full", "dots", "none"):
        raise ValueError(f"remat {remat!r}: full, dots or none")
    kinds = slot_kinds(c)
    n = _n_periods(layers["slot0"])
    per_slot = [_unstack(layers[f"slot{i}"], n) for i in range(len(kinds))]
    per_ekv = [None if enc_kv is None else _unstack(enc_kv[f"slot{i}"], n)
               for i in range(len(kinds))]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(n):
        for i, (mixer, ffn) in enumerate(kinds):
            args = (c, per_slot[i][j], x, causal, mixer, ffn,
                    None if enc_kv is None else per_ekv[i][j], impl)
            if remat == "none":
                x, a = _slot_forward(*args)
            else:
                # no op in a layer draws random numbers: no RNG state to keep
                kw = {"context_fn": _dots_context} if remat == "dots" else {}
                x, a = checkpoint(_slot_forward, *args, use_reentrant=False,
                                  preserve_rng_state=False, **kw)
            aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Prefill / decode (serving)
# ---------------------------------------------------------------------------


def stack_prefill(c: ModelConfig, layers: Params, x: torch.Tensor, *,
                  impl: str = "repeat",
                  positions: Optional[torch.Tensor] = None,
                  enc_kv: Params = None,
                  paged_prefix: Params = None,
                  paged_tables: Optional[torch.Tensor] = None):
    """Full-sequence causal pass that also emits per-layer caches.

    ``paged_prefix`` is the pool cache tree (attention slots' k/v leaves
    ``(n_periods, n_blocks, bs, Kh, Dh)``, plus k/v_scale leaves on an
    int8 pool) and ``paged_tables`` (B, npre) each row's prefix block
    ids: attention then runs the paged prefill kernel against the prefix
    held in the pool. Attention-only stacks: a mamba recurrence depends
    on the whole sequence and cannot skip the prefix (ValueError).
    Returns (x, caches): attention slots ``{"k", "v"}`` of shape
    (n_periods, B, S, Kh, Dh), mamba slots ``{"ssm", "conv"}``: the fp32
    state (n_periods, B, nh, hp, ns) and the pre-conv tail
    (n_periods, B, K-1, d_inner + 2 ns).
    """
    kinds = slot_kinds(c)
    if paged_prefix is not None and any(m != "attn" for m, _f in kinds):
        raise ValueError("prefix caching requires attention-only stacks "
                         "(a mamba recurrence runs through the whole "
                         "sequence)")
    out: dict = {f"slot{i}": {} for i in range(len(kinds))}
    for j in range(_n_periods(layers["slot0"])):
        for i, (mixer, ffn) in enumerate(kinds):
            sp = layer(layers[f"slot{i}"], j)
            h = apply_norm(c, sp["norm1"], x)
            if mixer == "attn":
                pp = None
                if paged_prefix is not None:
                    pool = paged_prefix[f"slot{i}"]
                    pp = (pool["k"][j], pool["v"][j], *_scales(pool, j),
                          paged_tables)
                h, (k, v) = attn.prefill_attention(c, sp["attn"], h,
                                                   positions=positions,
                                                   impl=impl,
                                                   paged_prefix=pp)
                new = {"k": k, "v": v}
            else:
                h, (conv_tail, hstate) = ssm_mod.mamba_forward(
                    c, sp["mamba"], h, return_state=True)
                new = {"ssm": hstate, "conv": conv_tail}
            for name, t in new.items():
                out[f"slot{i}"].setdefault(name, []).append(t)
            x, _aux = _ffn(c, sp, _cross(c, sp, x + h, _ekv(enc_kv, i, j),
                                         impl), ffn)
    return x, {slot: {name: torch.stack(ts) for name, ts in tree.items()}
               for slot, tree in out.items()}


def stack_decode(c: ModelConfig, layers: Params, x: torch.Tensor,
                 caches: Params, pos: torch.Tensor, *,
                 impl: str = "grouped", enc_kv: Params = None,
                 block_tables: Optional[torch.Tensor] = None,
                 n_kv_blocks: Optional[int] = None):
    """One-token decode through the stack. Every attention layer writes
    its token into its own cache slice: with ``block_tables``, its pool
    (and, on an int8 pool, its scale slice) through the same
    ``(B, max_blocks)`` table; without, its dense rows at ``pos`` (per
    row, or shared). Every mamba layer overwrites its state rows (idle
    rows too: the next insert overwrites them). ``enc_kv`` feeds the
    cross slots (encdec). ``impl`` is the dense attention's and the cross
    slots' ``sdpa`` formulation. Returns (x, caches) — the caches object itself,
    updated."""
    kinds = slot_kinds(c)
    for j in range(_n_periods(layers["slot0"])):
        for i, (mixer, ffn) in enumerate(kinds):
            sp = layer(layers[f"slot{i}"], j)
            sc = caches[f"slot{i}"]
            h = apply_norm(c, sp["norm1"], x)
            if mixer == "attn":
                k_scale, v_scale = _scales(sc, j)
                h = attn.decode_attention(c, sp["attn"], h, sc["k"][j],
                                          sc["v"][j], pos, impl=impl,
                                          block_tables=block_tables,
                                          n_kv_blocks=n_kv_blocks,
                                          cache_k_scale=k_scale,
                                          cache_v_scale=v_scale)
            else:
                h, conv_s, ssm_s = ssm_mod.mamba_decode(
                    c, sp["mamba"], h, sc["conv"][j], sc["ssm"][j])
                sc["conv"][j].copy_(conv_s)
                sc["ssm"][j].copy_(ssm_s)
            x, _aux = _ffn(c, sp, _cross(c, sp, x + h, _ekv(enc_kv, i, j),
                                         impl), ffn)
    return x, caches


def _ekv(enc_kv: Params, i: int, j: int):
    """Slot ``i``'s encoder K/V of period ``j``, or None."""
    return None if enc_kv is None else layer(enc_kv[f"slot{i}"], j)


def _scales(pool: Params, i: int) -> tuple:
    """Period ``i``'s (k_scale, v_scale) views of an int8 pool, or
    (None, None) for an fp pool."""
    if "k_scale" not in pool:
        return None, None
    return pool["k_scale"][i], pool["v_scale"][i]
