"""The matrix-product work of a ResNet50 v1.5 step: the convolutions and
the head, counted from the shapes at the configuration's image size,
"SAME" output sizes ``ceil(n / stride)`` (the port's
``models.resnet.forward_flops``, per convolution). Forward, input
gradient and weight gradient each do the forward's operations; the stem
has no input gradient (the images need none). A pass's least bytes are
its two inputs read and its output written (the unpadded activations,
the kernel, the output). BatchNorm, ReLU, pooling and the residual adds
are not products and are not counted.
"""
from __future__ import annotations

from cbench.models.resnet import blocks
from cbench.work import Op, matmul


def _ceil(n: int, d: int) -> int:
    return -(-n // d)


def _conv(name, b, n, k, cin, cout, stride, passes=3, width=2) -> Op:
    out = _ceil(n, stride)
    flops = 2.0 * b * out * out * k * k * cin * cout
    byts = width * (b * n * n * cin + k * k * cin * cout
                    + b * out * out * cout)
    return Op(name, passes * flops, passes * byts)


def step_ops(cfg: dict, traffic: dict, width: int = 2) -> list:
    b, n = int(traffic["global_batch"]), cfg["img_size"]
    ops = [_conv("stem", b, n, 7, 3, cfg["width"], 2, passes=2,
                 width=width)]
    n = _ceil(_ceil(n, 2), 2)                # the stem, the max-pool
    for s, i, cin, w, stride in blocks(cfg):
        p = f"s{s}b{i}."
        ops.append(_conv(p + "conv1", b, n, 1, cin, w, 1, width=width))
        ops.append(_conv(p + "conv2", b, n, 3, w, w, stride, width=width))
        out = _ceil(n, stride)
        ops.append(_conv(p + "conv3", b, out, 1, w, 4 * w, 1, width=width))
        if stride != 1 or cin != 4 * w:
            ops.append(_conv(p + "proj", b, n, 1, cin, 4 * w, stride,
                             width=width))
        n, cin = out, 4 * w
    ops.append(matmul("head", b, cin, cfg["n_classes"], width=width))
    return ops
