"""Plain reference of ResNet50 v1.5: loss and gradients.

Written from the model's description: NCHW float32; "SAME" padding
(``total = max((ceil(n / s) - 1) s + k - n, 0)``, half of it before);
a 7x7/2 stem, BatchNorm, ReLU and a 3x3/2 max-pool padded with -inf;
bottleneck blocks (1x1, 3x3 with the stage's stride, 1x1 to four times
the width, each followed by BatchNorm; a strided 1x1 projection with
BatchNorm where the shape changes; the residual add, then ReLU);
global average pooling and the head; the mean cross-entropy. BatchNorm
normalizes by the batch's mean and biased variance over (N, H, W) with
eps 1e-5. Kernels come in HWIO, as the weights are drawn. The whole
batch goes through at once (BatchNorm's statistics need it), each
block recomputed in the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cbench.reference.lowp import Precision


def _pads(n: int, k: int, stride: int) -> tuple[int, int]:
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w_hwio, stride: int, prec: Precision):
    k = w_hwio.shape[0]
    (hl, hh), (wl, wh) = _pads(x.shape[2], k, stride), _pads(x.shape[3], k,
                                                            stride)
    x = F.pad(x, (wl, wh, hl, hh))
    return prec.conv(x, w_hwio.permute(3, 2, 0, 1), stride)


def _bn(x, p, name):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    scale = p[name + ".scale"][None, :, None, None]
    bias = p[name + ".bias"][None, :, None, None]
    return (x - mean) * torch.rsqrt(var + 1e-5) * scale + bias


def _block(P, pre, stride, x, prec):
    h = F.relu(_bn(_conv(x, P[pre + "conv1"], 1, prec), P, pre + "bn1"))
    h = F.relu(_bn(_conv(h, P[pre + "conv2"], stride, prec), P, pre + "bn2"))
    h = _bn(_conv(h, P[pre + "conv3"], 1, prec), P, pre + "bn3")
    if pre + "proj" in P:
        x = _bn(_conv(x, P[pre + "proj"], stride, prec), P, pre + "bn_proj")
    return F.relu(h + x)


def forward(cfg, P, images, prec: Precision, remat: bool = True):
    """images (N, H, W, 3) -> logits (N, n_classes)."""
    x = images.float().permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv(x, P["stem"], 2, prec), P, "bn_stem"))
    (hl, hh), (wl, wh) = _pads(x.shape[2], 3, 2), _pads(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (wl, wh, hl, hh), value=float("-inf")), 3, 2)
    for s, n in enumerate(cfg["stage_sizes"]):
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            args = (P, f"stages.{s}.{b}.", stride, x, prec)
            x = (checkpoint(_block, *args, use_reentrant=False) if remat
                 else _block(*args))
    return prec.mm(x.mean(dim=(2, 3)), P["head"]) + P["head_b"]


def loss_and_grads(cfg, P: dict, batch: dict, prec: Precision,
                   remat: bool = True):
    """``(mean loss, {name: gradient})`` of one step's batch."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in P.items()}
    with torch.enable_grad():
        logits = forward(cfg, leaves, batch["images"], prec, remat)
        labels = batch["labels"].long()
        loss = (torch.logsumexp(logits, -1)
                - logits.gather(-1, labels[:, None])[:, 0]).mean()
        gs = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, gs))
