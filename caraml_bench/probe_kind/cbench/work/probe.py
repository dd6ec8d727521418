"""The matrix-product work of the probe MLP's step: its two products,
the first with no input gradient (the images need none)."""
from __future__ import annotations

from cbench.work import matmul


def step_ops(cfg: dict, traffic: dict, width: int = 2) -> list:
    b, d = int(traffic["global_batch"]), 3 * cfg["img_size"] ** 2
    h, c = cfg["hidden"], cfg["n_classes"]
    return [matmul("w1", b, d, h, passes=2, width=width),
            matmul("w2", b, h, c, width=width)]
