"""Mamba2 — SSD (state-space duality) blocks.

Port of ``src/repro/models/ssm.py``. Training and prefill run the chunked
SSD algorithm (quadratic within a chunk, linear across chunks through a
carried state; the reference's ``lax.scan`` over chunks is a Python loop
here); decode is the O(1)-per-token state recurrence. ngroups=1 (B/C
shared across heads), as in the published mamba2-1.3b config.

Numerics follow the reference cast for cast: the causal conv sums its
taps in the activation dtype in order 0..K-1 and applies silu in fp32;
``dt``, ``A`` and the SSD state are fp32 ("state stays fp32" across
prefill -> decode); ``mamba_decode`` keeps the dtype of the state it is
given. Where JAX promotes mixed operand dtypes inside an einsum, the
port casts to the promoted dtype first (torch refuses mixed operands).
No kernel carries this path, in the reference as here:
``kernels.ref.ssd_chunk_ref`` is the scan's oracle.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, param_dtype_of

Params = Any


def mamba_init(gen, c: ModelConfig, lead=()) -> Params:
    """The reference's leaves and distributions; ``lead`` prepends the
    layer-stack axes."""
    pd = param_dtype_of(c)
    dev = gen.device
    di, ns, nh, kw = c.d_inner, c.ssm_state, c.ssm_nheads, c.ssm_conv
    conv_ch = di + 2 * ns
    f32 = torch.float32
    conv_w = torch.randn((*lead, kw, conv_ch), generator=gen, device=dev,
                         dtype=f32) * (1.0 / kw)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=dev))
    return {
        "in_proj": dense_init(gen, c.d_model, 2 * di + 2 * ns + nh, pd, lead),
        "conv_w": conv_w.to(pd),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=pd, device=dev),
        "dt_bias": torch.zeros((*lead, nh), dtype=f32, device=dev),
        "A_log": a_log.expand(*lead, nh).clone(),
        "D": torch.ones((*lead, nh), dtype=f32, device=dev),
        "norm_scale": torch.ones((*lead, di), dtype=pd, device=dev),
        "out_proj": dense_init(gen, di, c.d_model, pd, lead),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. xbc: (B, S, C); w: (K, C). Taps summed in
    xbc's dtype in order 0..K-1, silu in fp32."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu((out + b).float()).to(xbc.dtype)


def _conv_step(state: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """Single-token conv. state: (B, K-1, C); x_new: (B, 1, C). Returns
    (out (B, 1, C), the new state: the window's last K-1 rows)."""
    dt = torch.promote_types(state.dtype, x_new.dtype)
    window = torch.cat([state.to(dt), x_new.to(dt)], dim=1)       # (B, K, C)
    wdt = torch.promote_types(dt, w.dtype)
    out = torch.einsum("bkc,kc->bc", window.to(wdt), w.to(wdt)) + b
    out = F.silu(out.float()).to(x_new.dtype)
    return out[:, None, :], window[:, 1:, :]


def _split_proj(c: ModelConfig, zxbcdt: torch.Tensor):
    di, ns = c.d_inner, c.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * ns]
    dt = zxbcdt[..., di + di + 2 * ns:]
    return z, xbc, dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    g = (y * F.silu(z.float()).to(y.dtype)).float()
    ms = g.square().mean(-1, keepdim=True)
    return (g * torch.rsqrt(ms + eps) * scale.float()).to(y.dtype)


# ---------------------------------------------------------------------------
# SSD core (chunked scan)
# ---------------------------------------------------------------------------


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L). Returns (..., L, L): the summed decays of j+1..i at
    (i, j), -inf above the diagonal (so ``exp`` of it is 0 there, and so
    is its gradient)."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return ss.masked_fill(~mask, float("-inf"))


def ssd_chunked(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None):
    """Chunked SSD, one chunk at a time with the state carried across.

    xdt: (b, s, h, p) — inputs pre-multiplied by dt
    dA:  (b, s, h)    — dt * A (negative)
    B,C: (b, s, n)    — shared across heads (ngroups=1)
    Returns y (b, s, h, p) in xdt's dtype and the final state
    (b, h, p, n) in fp32. Each step materializes one chunk's (l, l)
    decay block; the training forward's per-layer recomputation
    (``blocks.stack_forward``) bounds what the backward keeps.
    """
    b, s, nh, p = xdt.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    f32 = torch.float32
    h = (torch.zeros((b, nh, p, n), dtype=f32, device=xdt.device)
         if h0 is None else h0.to(f32))
    ys = []
    for j in range(s // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        xc = xdt[:, sl].to(f32)                              # (b,l,h,p)
        dac = dA[:, sl].to(f32)                              # (b,l,h)
        bc, cc = B[:, sl], C[:, sl]                          # (b,l,n)
        da_cs = torch.cumsum(dac, dim=1)                     # (b,l,h)
        # intra-chunk (one (l, l) decay block, transient)
        L = torch.exp(_segsum(dac.transpose(1, 2)))         # (b,h,l,l)
        scores = torch.einsum("bln,bsn->bls", cc, bc).to(f32)
        y = torch.einsum("bhls,bshp->blhp", scores[:, None] * L, xc)
        # carried-in state contribution
        y = y + (torch.einsum("bln,bhpn->blhp", cc.to(f32), h)
                 * torch.exp(da_cs)[..., None])
        # state update
        end = da_cs[:, -1]                                   # (b,h)
        decay_to_end = torch.exp(end[:, None] - da_cs)       # (b,l,h)
        h = (h * torch.exp(end)[..., None, None]
             + torch.einsum("bln,blhp->bhpn", bc.to(f32),
                            xc * decay_to_end[..., None]))
        ys.append(y.to(xdt.dtype))
    return torch.cat(ys, dim=1), h


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """One-token SSD recurrence, in the operands' promoted dtype.

    h: (b, nh, p, n); x: (b, nh, p); dt: (b, nh); A: (nh,); B/C: (b, n).
    Returns (y (b, nh, p), h_new).
    """
    f = h.dtype
    for t in (x, dt, A, B, C):
        f = torch.promote_types(f, t.dtype)
    dt, A = dt.to(f), A.to(f)
    dA = torch.exp(dt * A)                                    # (b, nh)
    dBx = torch.einsum("bh,bhp,bn->bhpn", dt, x.to(f), B.to(f))
    h_new = h.to(f) * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", h_new, C.to(f))
    return y, h_new


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------


def ssd_chunk_size(c: ModelConfig, s: int) -> int:
    """The reference's chunk rule: the largest divisor of ``s`` not above
    ``ssm_chunk`` (a prime ``s`` above it gets chunk 1: ``s`` sequential
    steps)."""
    chunk = min(c.ssm_chunk, s)
    while s % chunk:
        chunk -= 1
    return chunk


def mamba_forward(c: ModelConfig, p: Params, x: torch.Tensor,
                  h0: Optional[torch.Tensor] = None,
                  return_state: bool = False):
    """x: (B, S, D) -> (B, S, D). Chunked SSD over the sequence; with
    ``return_state`` also (conv_tail, ssm_state): the last K-1 *pre-conv*
    rows and the final fp32 state, for decode continuity."""
    b, s, _ = x.shape
    di, ns, nh, hp = c.d_inner, c.ssm_state, c.ssm_nheads, c.ssm_headdim
    z, xbc_raw, dt_raw = _split_proj(c, x @ p["in_proj"])
    conv_tail = xbc_raw[:, -(c.ssm_conv - 1):, :]
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xin, B, C = xbc[..., :di], xbc[..., di:di + ns], xbc[..., di + ns:]
    dt = torch.logaddexp(dt_raw.float() + p["dt_bias"],
                         torch.zeros((), device=x.device))   # softplus
    A = -torch.exp(p["A_log"])                                # (nh,)
    xh = xin.reshape(b, s, nh, hp)
    xdt = xh * dt[..., None].to(xh.dtype)
    dA = dt * A
    y, h_fin = ssd_chunked(xdt, dA, B, C, ssd_chunk_size(c, s), h0=h0)
    y = y.to(xh.dtype) + xh * p["D"].to(xh.dtype)[:, None]
    y = y.reshape(b, s, di)
    y = _gated_norm(y, z, p["norm_scale"])
    out = (y @ p["out_proj"]).to(x.dtype)
    if return_state:
        return out, (conv_tail, h_fin)
    return out


def mamba_decode(c: ModelConfig, p: Params, x: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One-token decode. x: (B, 1, D). Returns (out, conv_state,
    ssm_state), the new states in the dtypes of those given."""
    b = x.shape[0]
    di, ns, nh, hp = c.d_inner, c.ssm_state, c.ssm_nheads, c.ssm_headdim
    z, xbc, dt_raw = _split_proj(c, x @ p["in_proj"])
    xbc, conv_state = _conv_step(conv_state, xbc, p["conv_w"], p["conv_b"])
    xin, B, C = xbc[..., :di], xbc[..., di:di + ns], xbc[..., di + ns:]
    dt = torch.logaddexp(dt_raw[:, 0].float() + p["dt_bias"],
                         torch.zeros((), device=x.device))   # (b, nh)
    A = -torch.exp(p["A_log"])
    xh = xin[:, 0].reshape(b, nh, hp)
    in_state_dtype = ssm_state.dtype
    y, ssm_state = ssd_decode_step(ssm_state, xh, dt, A, B[:, 0], C[:, 0])
    ssm_state = ssm_state.to(in_state_dtype)
    y = y.to(xh.dtype) + xh * p["D"].to(xh.dtype)[:, None]
    y = y.reshape(b, 1, di)
    y = _gated_norm(y, z, p["norm_scale"])
    return (y @ p["out_proj"]).to(x.dtype), conv_state, ssm_state


def mamba_state_shapes(c: ModelConfig, batch: int):
    """(conv, ssm) state shapes of one layer for ``batch`` rows."""
    conv = (batch, c.ssm_conv - 1, c.d_inner + 2 * c.ssm_state)
    ssm = (batch, c.ssm_nheads, c.ssm_headdim, c.ssm_state)
    return conv, ssm
