"""Training-mode BatchNorm on the card: wrapper of ``csrc/batchnorm.cu``.

Replaces no TPU kernel: the reference's BatchNorm
(``src/repro/models/resnet.py::batchnorm``) is XLA array code. It
replaces the port's composition on the card (fp32 casts around cuDNN's
BatchNorm, then separate ReLU and residual-add passes); the source
file's note gives the function, the bound and the design. The plain
version is ``kernels.ref.batchnorm_ref``, the CPU path.

:func:`batchnorm` is differentiable (:class:`BatchNormFn`): the forward
is two launches (statistics, then apply) and so is the backward
(gradient sums, then dx). It saves ``x`` in its own type and the two
fp32 vectors mean and rstd, plus the output for ``add_relu``.
``batchnorm.launches`` counts the launches: four a call with its
backward.

Inputs are channels_last ``(N, C, H, W)`` tensors, read as ``[M, C]``
row-major with ``M = N*H*W``; ``C`` must be whole 16-byte vectors and
every activation 16-byte aligned. The wrapper raises on anything else:
there is no fallback to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODES

#: the epilogues (``kNone``, ``kRelu``, ``kAddRelu`` in the source)
ACTS = {"none": 0, "relu": 1, "add_relu": 2}
#: threads of a block and channels of its tile (``kThreads``, ``kTile``)
THREADS = 256
TILE = 64


def rows_per_pass(esize: int) -> int:
    """Rows a block covers in one pass: its threads over a tile's
    16-byte vectors (32 in bf16, 16 in fp32)."""
    return THREADS // (TILE * esize // 16)


def plan(m: int, c: int, esize: int, slots: int) -> tuple[int, int]:
    """``(chunks, rows a chunk)`` of one kernel over ``[m, c]``: the
    chunks times the channel tiles fill at most ``slots`` blocks (the
    card's resident blocks of the kernel, so one wave), each chunk a
    whole number of block passes, none empty."""
    rows = rows_per_pass(esize)
    tiles = -(-c // TILE)
    chunks = max(1, min(slots // tiles, -(-m // rows)))
    per = -(-m // chunks)
    per = -(-per // rows) * rows
    return -(-m // per), per


@functools.lru_cache(maxsize=None)
def _occupancy(act: int, dtype: int, param_dtype: int) -> tuple:
    """Resident blocks an SM of the statistics, apply, gradient-sum and
    dx kernels of one instance (read once)."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.load_library().repro_batchnorm_occupancy(
        act, dtype, param_dtype, out), "batchnorm occupancy")
    return tuple(out)


@functools.lru_cache(maxsize=512)
def _plans(m: int, c: int, esize: int, sms: int, occupancy: tuple) -> tuple:
    """The forward's and the backward's ``(chunks, rows a chunk)`` of the
    reduction, then of the elementwise kernel: four ints each."""
    (a, b), (d, e), (f, g), (h, i) = (plan(m, c, esize, k * sms)
                                      for k in occupancy)
    return (a, b, d, e), (f, g, h, i)


#: each (card, stream)'s tickets and scratch (``_build.StreamState``): a
#: ticket a channel tile, and the partials of the reductions and the
#: backward's two coefficients (``part`` then ``coef`` in the source)
_STATES: dict = {}


def _act_code(act: str, with_tensor: bool) -> int:
    """The epilogue's code; ``add_relu``, and it alone, takes the
    shortcut forward and the output backward."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if (act == "add_relu") != with_tensor:
        raise ValueError(f"act {act!r} with{'' if with_tensor else 'out'} "
                         f"the shortcut: it goes with add_relu alone")
    return ACTS[act]


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           others) -> None:
    """Device, types, shapes, layout and alignment the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {x.device}")
    if x.dtype not in DTYPE_CODES or scale.dtype not in DTYPE_CODES:
        raise TypeError(f"x and scale must be {sorted(map(str, DTYPE_CODES))}"
                        f", got {x.dtype} and {scale.dtype}")
    if bias.dtype != scale.dtype:
        raise TypeError(f"bias {bias.dtype} and scale {scale.dtype} differ")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    if x.numel() == 0:
        raise ValueError(f"x {tuple(x.shape)} has no element")
    if scale.shape != (c,) or bias.shape != (c,) or not (
            scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be contiguous ({c},)")
    if c * x.element_size() % 16:
        raise ValueError(f"C = {c} is not whole 16-byte vectors of "
                         f"{x.dtype}")
    for t in (x, scale, bias, *others):
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}: the "
                             f"kernel takes one card")
    for t in (x, *others):
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{tuple(t.shape)} {t.dtype} beside x "
                             f"{tuple(x.shape)} {x.dtype}")
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("activations must be channels_last contiguous")
        if t.data_ptr() % 16:
            raise ValueError("activations must be 16-byte aligned")
    if x.numel() // c >= 2 ** 31:
        raise ValueError(f"M = {x.numel() // c} rows: the kernels index "
                         f"rows with 32 bits")


def _launch_args(x: torch.Tensor, code: int, param_dtype: torch.dtype):
    """``(M, C, forward plans, backward plans, stream state, stream)``."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    state = _build.stream_state(_STATES, "batchnorm", x.device, stream, 64)
    c = x.shape[1]
    m = x.numel() // c
    fwd, bwd = _plans(m, c, x.element_size(), state.sms, _occupancy(
        code, DTYPE_CODES[x.dtype], DTYPE_CODES[param_dtype]))
    return m, c, fwd, bwd, state, stream


def forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
            act: str = "none", residual: Optional[torch.Tensor] = None,
            eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, stats)``: y in x's type and layout, stats ``(2, C)`` fp32
    (mean, rstd). ``act`` is a key of :data:`ACTS`; ``residual`` (the
    shortcut) goes with ``add_relu`` alone."""
    code = _act_code(act, residual is not None)
    _check(x, scale, bias, () if residual is None else (residual,))
    m, c, plans, _, state, stream = _launch_args(x, code, scale.dtype)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    part = state.scratch_ptr(2 * plans[0] * c)
    err = _build.load_library().repro_batchnorm_forward(
        x.data_ptr(), 0 if residual is None else residual.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), y.data_ptr(), stats.data_ptr(),
        part, state.tickets_ptr(-(-c // TILE)), m, c, *plans, float(eps),
        code, DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype], stream)
    _build.check(err, "batchnorm forward")
    batchnorm.launches += 2
    return y, stats


def backward(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor, stats: torch.Tensor, *, act: str = "none",
             out: Optional[torch.Tensor] = None) -> tuple:
    """``(dx, d_residual, dscale, dbias)`` of :func:`forward`: dx (and
    d_residual, ``None`` unless ``add_relu``) in x's type, dscale and
    dbias in the params' type. ``out`` is the forward's output, which
    ``add_relu`` reads for its mask; ``dy`` of any layout."""
    code = _act_code(act, out is not None)
    dy = dy.contiguous(memory_format=torch.channels_last)
    _check(x, scale, bias, (dy,) if out is None else (dy, out))
    if stats.shape != (2, x.shape[1]) or stats.dtype != torch.float32 \
            or not stats.is_contiguous() or stats.device != x.device:
        raise ValueError(f"stats must be (2, C) fp32 on x's card, got "
                         f"{tuple(stats.shape)} {stats.dtype}")
    m, c, _, plans, state, stream = _launch_args(x, code, scale.dtype)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dsc = None if out is None else torch.empty_like(dx)
    dparams = torch.empty((2, c), dtype=scale.dtype, device=x.device)
    part = state.scratch_ptr(2 * plans[0] * c + 2 * c)
    coef = part + 4 * 2 * plans[0] * c         # bytes past the partials
    err = _build.load_library().repro_batchnorm_backward(
        dy.data_ptr(), x.data_ptr(), 0 if out is None else out.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), stats.data_ptr(), dx.data_ptr(),
        0 if dsc is None else dsc.data_ptr(), dparams.data_ptr(), coef,
        part, state.tickets_ptr(-(-c // TILE)), m, c, *plans, code,
        DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype], stream)
    _build.check(err, "batchnorm backward")
    batchnorm.launches += 2
    return dx, dsc, dparams[0], dparams[1]


class BatchNormFn(torch.autograd.Function):
    """:func:`forward` with :func:`backward` as its gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, act, eps):
        y, stats = forward(x, scale, bias, act=act, residual=residual,
                           eps=eps)
        ctx.act = act
        ctx.save_for_backward(x, scale, bias, stats,
                              y if act == "add_relu" else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, stats, out = ctx.saved_tensors
        dx, dsc, dscale, dbias = backward(dy, x, scale, bias, stats,
                                          act=ctx.act, out=out)
        return dx, dscale, dbias, dsc, None, None


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              act: str = "none", residual: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    """Batch-statistics BatchNorm of channels_last ``x`` (N, C, H, W) over
    (N, H, W), then the epilogue ``act`` (``"add_relu"`` adds
    ``residual`` to the rounded output before the ReLU); differentiable
    in x, scale, bias and residual."""
    return BatchNormFn.apply(x, scale, bias, residual, act, eps)


batchnorm.launches = 0
