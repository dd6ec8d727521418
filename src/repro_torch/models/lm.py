"""Language models: decoder-only (dense, moe, ssm, hybrid, vlm) and
encoder-decoder (the whisper backbone).

Port of ``src/repro/models/lm.py``: ``init`` (the port's own seeded
initializer, drawing the reference's distributions from a
``torch.Generator``), ``init_abstract`` (the same tree on the ``meta``
device: shapes and dtypes, no storage), ``encode``, ``forward`` (training: ``remat`` and
``impl`` as in the reference; returns the MoE aux loss summed over the
stack), ``prefill`` and ``decode_step`` (``impl`` with the reference's
defaults: ``"repeat"`` for prefill, ``"grouped"`` for decode). Both front ends are stubs, in
the reference too: an encdec model takes precomputed encoder frames
``enc_frames`` (B, enc_seq, D), a vlm precomputed patch embeddings
``patch_embeds`` (B, n_patches, D), which go before the text (RoPE
positions run over patches and text together).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import (
    apply_mlp, apply_norm, dtype_of, embed_tokens, embedding_init, norm_init,
    param_dtype_of, unembed,
)

Params = Any


def init(c: ModelConfig, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> Params:
    """Random parameters with the reference's tree, layouts and
    distributions (not its random bits). ``device`` defaults to the CUDA
    card; ``generator`` defaults to one seeded with 0 on that device. An
    encdec model also has ``encoder`` (``layers``, ``norm`` and learned
    frame positions ``pos`` (enc_seq, D), normal x 0.02)."""
    dev = resolve_device(device)
    gen = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    p = {"embed": embedding_init(gen, c),
         "layers": blocks.stack_init(gen, c, cross=c.family == "encdec"),
         "final_norm": norm_init(c, dev)}
    if c.family == "encdec":
        pos = torch.randn((c.enc_seq, c.d_model), generator=gen, device=dev,
                          dtype=torch.float32) * 0.02
        p["encoder"] = {"layers": blocks.enc_stack_init(gen, c),
                        "norm": norm_init(c, dev),
                        "pos": pos.to(param_dtype_of(c))}
    return p


class _OnMeta(TorchFunctionMode):
    """Every torch call that names a device gets ``meta`` instead."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def init_abstract(c: ModelConfig) -> Params:
    """Shape-only params: :func:`init`'s tree on the ``meta`` device (the
    reference's ``jax.eval_shape`` of its init), so no memory is taken
    and no random number is drawn. The CPU generator only satisfies
    ``init``'s signature."""
    with _OnMeta():
        return init(c, torch.Generator(), "cpu")


def _inputs_to_embeds(c: ModelConfig, p: Params, tokens: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor],
                      pos_offset: int = 0) -> torch.Tensor:
    """Token embeddings (with learned positions where the model has them);
    a vlm's patch embeddings, cast to the activations' dtype, go first."""
    positions = torch.arange(tokens.shape[1],
                             device=tokens.device)[None, :] + pos_offset
    x = embed_tokens(c, p["embed"], tokens, positions)
    if c.family == "vlm" and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def _enc_layer(c: ModelConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(c, lp["norm1"], x)
    x = x + attn.self_attention(c, lp["attn"], h, causal=False)
    return x + apply_mlp(c, lp["mlp"], apply_norm(c, lp["norm2"], x))


def encode(c: ModelConfig, p: Params, frames: torch.Tensor):
    """The whisper-backbone encoder over precomputed frame embeddings
    (B, enc_seq, D). Returns (encoder output, the decoder's cross K/V:
    per period ``{"slot{i}": {"k", "v"}}``, each (n_periods, B, T_enc,
    Kh, Dh)). With gradients on each encoder layer is recomputed in the
    backward, as the reference's ``jax.checkpoint`` does."""
    enc = p["encoder"]
    dt = dtype_of(c)
    x = frames.to(dt) + enc["pos"][None].to(dt)
    n = c.n_enc_layers
    for lp in blocks._unstack(enc["layers"], n):
        if torch.is_grad_enabled():
            x = checkpoint(_enc_layer, c, lp, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _enc_layer(c, lp, x)
    enc_out = apply_norm(c, enc["norm"], x)
    layers = p["layers"]
    n_periods = blocks._n_periods(layers["slot0"])
    enc_kv = {}
    for i in range(len(blocks.slot_kinds(c))):
        ks, vs = [], []
        for lp in blocks._unstack(layers[f"slot{i}"]["cross"], n_periods):
            k, v = attn.encoder_kv(c, lp, enc_out)
            ks.append(k)
            vs.append(v)
        enc_kv[f"slot{i}"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return enc_out, enc_kv


def _enc_kv(c: ModelConfig, p: Params, enc_frames):
    """An encdec model's cross K/V from ``enc_frames`` (which it needs),
    else None."""
    if c.family != "encdec":
        return None
    if enc_frames is None:
        raise ValueError(f"{c.name} (encdec) needs enc_frames")
    return encode(c, p, enc_frames)[1]


def forward(c: ModelConfig, p: Params, tokens: torch.Tensor, *,
            patch_embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            impl: str = "repeat", remat: str = "full"):
    """Full causal forward over (B, S) tokens -> (logits, aux_loss), the
    training path (``blocks.stack_forward``: no caches; aux_loss sums the
    MoE slots' load-balancing losses, 0 without MoE). A vlm's logits
    cover the text positions only (all positions without patches)."""
    enc_kv = _enc_kv(c, p, enc_frames)
    x = _inputs_to_embeds(c, p, tokens, patch_embeds)
    x, aux = blocks.stack_forward(c, p["layers"], x, causal=True, impl=impl,
                                  remat=remat, enc_kv=enc_kv)
    x = apply_norm(c, p["final_norm"], x)
    if c.family == "vlm" and patch_embeds is not None:
        x = x[:, patch_embeds.shape[1]:]
    return unembed(c, p["embed"], x), aux


def prefill(c: ModelConfig, p: Params, tokens: torch.Tensor, *,
            patch_embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            impl: str = "repeat", last_pos: Optional[torch.Tensor] = None,
            pos_offset: int = 0, paged_prefix: Params = None,
            paged_tables: Optional[torch.Tensor] = None):
    """Process a (right-padded) prompt batch; return (logits at each
    row's ``last_pos`` — default the last column —, per-layer caches,
    the encoder's cross K/V or None). A vlm's caches hold its patches'
    rows before the text's.

    ``paged_prefix`` + ``paged_tables`` + ``pos_offset`` select the
    prefix-cached suffix prefill: ``tokens`` holds only the suffix (global
    positions start at ``pos_offset = npre * block_size``), the prefix
    K/V stays in the pool and attention walks ``paged_tables`` (B, npre).
    The returned caches cover only the suffix.
    """
    has_prefix = paged_prefix is not None
    if has_prefix != (pos_offset > 0):
        raise ValueError(f"pos_offset={pos_offset} needs paged_prefix "
                         "(and only then)")
    x = _inputs_to_embeds(c, p, tokens, patch_embeds, pos_offset)
    enc_kv = _enc_kv(c, p, enc_frames)
    positions = None
    if has_prefix:
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :] + pos_offset
    x, caches = blocks.stack_prefill(c, p["layers"], x, impl=impl,
                                     positions=positions, enc_kv=enc_kv,
                                     paged_prefix=paged_prefix,
                                     paged_tables=paged_tables)
    if last_pos is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, last_pos.long()][:, None]
    else:
        x_last = x[:, -1:]
    x_last = apply_norm(c, p["final_norm"], x_last)
    return unembed(c, p["embed"], x_last), caches, enc_kv


def decode_step(c: ModelConfig, p: Params, token: torch.Tensor,
                caches: Params, pos, *, enc_kv: Params = None,
                impl: str = "grouped",
                block_tables: Optional[torch.Tensor] = None,
                n_kv_blocks: Optional[int] = None):
    """token: (B, 1); pos: (B,) per-slot positions, or one position
    shared by every row (an int or a 0-d tensor; dense caches only).
    ``block_tables`` selects the paged pools, else ``caches`` holds dense
    rows (the slotted cache). ``enc_kv``: an encdec model's cross K/V
    (``prefill``'s third result). ``impl``: the dense attention's
    ``sdpa`` formulation. The caches are updated in place.
    Returns (logits, caches)."""
    if torch.is_tensor(pos) and pos.ndim == 1:
        positions = pos[:, None]
    else:
        positions = torch.full_like(token, int(pos))
    x = embed_tokens(c, p["embed"], token, positions)
    x, caches = blocks.stack_decode(c, p["layers"], x, caches, pos,
                                    impl=impl, enc_kv=enc_kv,
                                    block_tables=block_tables,
                                    n_kv_blocks=n_kv_blocks)
    x = apply_norm(c, p["final_norm"], x)
    return unembed(c, p["embed"], x), caches
