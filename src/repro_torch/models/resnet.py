"""ResNet50 (v1.5) — the paper's computer-vision benchmark case.

Port of ``src/repro/models/resnet.py``: ``init``, ``conv``,
``batchnorm``, ``bottleneck`` and ``forward``, with the reference's
parameter tree and layouts (HWIO kernels, ``stages`` a list of lists of
block dicts, ``head`` ``(C, n_classes)``), so the bridge, the optimizer
and checkpoint keys line up leaf for leaf.

What the port does differently, and why the numbers do not move:

  * **Layout.** The reference runs NHWC activations. The port permutes
    the NHWC images once at the stem: ``x.permute(0, 3, 1, 2)`` is an
    NCHW view of NHWC bytes, i.e. ``channels_last`` memory, which
    ``F.conv2d`` (cuDNN on the card) keeps from layer to layer. Kernels
    enter each convolution as ``w.permute(3, 2, 0, 1)`` (HWIO -> OIHW), a
    view that the convolution copies into its own layout.
  * **"SAME" padding.** XLA pads ``total = max((ceil(n/s) - 1) s + k - n,
    0)``, ``total // 2`` low and the rest high: (2, 3) for the 7x7/2 stem
    on 224, (0, 1) for a 3x3/2 conv on 56, nothing for a 1x1/2
    projection. ``F.conv2d`` pads symmetrically only, so an asymmetric
    pad goes through ``F.pad`` first; the max-pool pads with ``-inf`` the
    same way (the reference's ``reduce_window`` initial value).
  * **BatchNorm** computes in fp32 from the batch's statistics over
    (N, H, W) with the biased variance, and rounds the output once to
    the input's dtype, as the reference does. The ReLU after it, or the
    block's shortcut add and ReLU after its last one, are the call's
    epilogue (``act``, ``residual``), so that on the card one
    hand-written kernel pair (``kernels/batchnorm.py``) reads and writes
    the activations' own dtype and fuses them: the output is rounded
    before the shortcut is added, as the reference's separate add does.
    On the CPU the plain version (``kernels.ref.batchnorm_ref``:
    ``F.batch_norm`` in fp32, the cast, then the ReLU or the add) runs.
    The reference returns the batch statistics beside the output and
    every caller discards them (its running-stats state ``_bn_state`` is
    never updated), so the port returns the output alone and keeps no
    running statistics.
  * **Data parallelism.** The reference runs the data-parallel step
    under GSPMD, so its batch statistics are over the whole global
    batch. Given a process group (``forward(..., stats_group=)``), the
    port's BatchNorm all-reduces the per-channel sums of ``x`` and of
    ``(x - mean)**2`` over the ranks (:class:`AllReduceSum`, whose
    backward all-reduces the two gradient sums too), so every rank
    normalizes by the global mean and biased variance.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.resnet50 import ResNetConfig
from repro_torch.core.ranges import bracket, span
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import group_size

Params = Any


def _conv_init(gen, kh, kw, cin, cout, dtype):
    std = math.sqrt(2.0 / (kh * kw * cin))
    return (torch.randn((kh, kw, cin, cout), generator=gen,
                        dtype=torch.float32, device=gen.device)
            * std).to(dtype)


def _bn_init(ch, dtype, dev):
    return {"scale": torch.ones((ch,), dtype=dtype, device=dev),
            "bias": torch.zeros((ch,), dtype=dtype, device=dev)}


def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: ``(low, high)``."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """``x`` (NCHW) padded as "SAME" asks where that is asymmetric;
    returns ``(x, symmetric (ph, pw) left for the op itself)``."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], k, stride),
                          same_pads(x.shape[3], k, stride))
    if hl == hh and wl == wh:
        return x, (hl, wl)
    x = F.pad(x, (wl, wh, hl, hh), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """"SAME" convolution: ``x`` (N, C, H, W) in channels_last memory,
    ``w`` HWIO -> (N, O, H', W')."""
    x, pad = _pad_same(x, w.shape[0], stride)
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=pad)


def max_pool(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """The stem's 3x3/2 "SAME" max-pool, ``-inf`` padded."""
    x, pad = _pad_same(x, k, stride, value=-math.inf)
    return F.max_pool2d(x, k, stride, padding=pad)


class AllReduceSum(torch.autograd.Function):
    """Sum over a process group; its gradient is the sum over the group
    of the ranks' gradients (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batchnorm(p: Params, x: torch.Tensor, eps: float = 1e-5, group=None,
              act: str = "none",
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-statistics BatchNorm over (N, H, W) of ``x`` (N, C, H, W),
    in fp32, rounded to ``x.dtype``, then the epilogue ``act``:
    ``"none"``, ``"relu"``, or ``"add_relu"``, ``relu(y + residual)``.
    With ``group`` the statistics are over every rank's rows (equal row
    counts). Under a profiler the call and its backward, the epilogue's
    included, are each a range ``batchnorm``."""
    with span("batchnorm"):
        return bracket("batchnorm",
                       lambda s, b, v: _batchnorm(s, b, v, eps, group, act,
                                                  residual),
                       p["scale"], p["bias"], x)


def _batchnorm(scale, bias, x, eps, group, act, residual):
    if group is None:
        return ops.batchnorm(x, scale, bias, act=act, residual=residual,
                             eps=eps)
    xf = x.float()
    n = xf.numel() // xf.shape[1] * group_size(group)
    mean = AllReduceSum.apply(xf.sum((0, 2, 3)), group) / n
    xc = xf - mean[:, None, None]
    var = AllReduceSum.apply((xc * xc).sum((0, 2, 3)), group) / n
    y = xc * torch.rsqrt(var + eps)[:, None, None]
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    return ref.bn_epilogue(y.to(x.dtype), act, residual)


def bottleneck_init(gen, cin, width, stride, dtype):
    cout = width * 4
    p = {"conv1": _conv_init(gen, 1, 1, cin, width, dtype),
         "bn1": _bn_init(width, dtype, gen.device),
         "conv2": _conv_init(gen, 3, 3, width, width, dtype),
         "bn2": _bn_init(width, dtype, gen.device),
         "conv3": _conv_init(gen, 1, 1, width, cout, dtype),
         "bn3": _bn_init(cout, dtype, gen.device)}
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout, dtype)
        p["bn_proj"] = _bn_init(cout, dtype, gen.device)
    return p


def bottleneck(p: Params, x: torch.Tensor, stride: int,
               group=None) -> torch.Tensor:
    """``relu(bn3(conv3(h)) + shortcut)``; the shortcut is made first, so
    that the backward of its BatchNorm runs after the block's other
    BatchNorm backwards and no two ``batchnorm`` ranges nest."""
    sc = x
    if "proj" in p:
        sc = batchnorm(p["bn_proj"], conv(x, p["proj"], stride), group=group)
    h = batchnorm(p["bn1"], conv(x, p["conv1"]), group=group, act="relu")
    h = batchnorm(p["bn2"], conv(h, p["conv2"], stride), group=group,
                  act="relu")
    return batchnorm(p["bn3"], conv(h, p["conv3"]), group=group,
                     act="add_relu", residual=sc)


def _strides(c: ResNetConfig):
    """``(stage, block, stride)`` of every bottleneck, in order."""
    for s, n_blocks in enumerate(c.stage_sizes):
        for b in range(n_blocks):
            yield s, b, 2 if (b == 0 and s > 0) else 1


def init(c: ResNetConfig, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> Params:
    """Random parameters with the reference's tree, layouts and
    distributions (He-normal kernels drawn in fp32, then cast; the head
    at 0.01; BN scale 1, bias 0), not its random bits. ``device``
    defaults to the CUDA card; ``generator`` to one seeded with 0
    there."""
    dev = resolve_device(device)
    gen = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    dtype = getattr(torch, c.param_dtype)
    p = {"stem": _conv_init(gen, 7, 7, 3, c.width, dtype),
         "bn_stem": _bn_init(c.width, dtype, dev),
         "stages": [[] for _ in c.stage_sizes]}
    cin = c.width
    for s, _b, stride in _strides(c):
        width = c.width * (2 ** s)
        p["stages"][s].append(bottleneck_init(gen, cin, width, stride,
                                              dtype))
        cin = width * 4
    p["head"] = (torch.randn((cin, c.n_classes), generator=gen,
                             dtype=torch.float32, device=dev)
                 * 0.01).to(dtype)
    p["head_b"] = torch.zeros((c.n_classes,), dtype=dtype, device=dev)
    return p


def forward(c: ResNetConfig, p: Params, images: torch.Tensor,
            stats_group=None) -> torch.Tensor:
    """images: (B, H, W, 3) -> logits (B, n_classes); BatchNorm's
    statistics over ``stats_group``'s ranks when given."""
    x = images.to(getattr(torch, c.dtype)).permute(0, 3, 1, 2)
    x = batchnorm(p["bn_stem"], conv(x, p["stem"], stride=2),
                  group=stats_group, act="relu")
    x = max_pool(x)
    for s, b, stride in _strides(c):
        x = bottleneck(p["stages"][s][b], x, stride, stats_group)
    x = x.mean(dim=(2, 3))
    return x @ p["head"] + p["head_b"]


def forward_flops(c: ResNetConfig) -> int:
    """Operations of one image's forward pass (2 a multiply-add), counted
    from the convolutions' and the head's shapes at ``c.img_size`` with
    "SAME" output sizes (``ceil(n / stride)``); BN, ReLU and pooling are
    left out, as a model-FLOP count leaves them out."""
    def conv_flops(n, k, cin, cout, stride):
        out = -(-n // stride)
        return 2 * out * out * k * k * cin * cout, out

    total, n = conv_flops(c.img_size, 7, 3, c.width, 2)
    n = -(-n // 2)                                  # the max-pool
    cin = c.width
    for s, _b, stride in _strides(c):
        width = c.width * (2 ** s)
        f1, _ = conv_flops(n, 1, cin, width, 1)
        f2, n_out = conv_flops(n, 3, width, width, stride)
        f3, _ = conv_flops(n_out, 1, width, width * 4, 1)
        total += f1 + f2 + f3
        if stride != 1 or cin != width * 4:
            total += conv_flops(n, 1, cin, width * 4, stride)[0]
        n, cin = n_out, width * 4
    return total + 2 * cin * c.n_classes
