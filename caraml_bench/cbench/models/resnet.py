"""ResNet50 v1.5 (``arch: "resnet"``) on the port's
``repro_torch.train.step.make_resnet_train_step`` (one rank).

The weights are the benchmark's (``leaf_specs``): the port's tree (HWIO
kernels, ``stages`` a list of lists of blocks), every leaf drawn from
the seed; the port makes its optimizer state with its own ``opt_init``.
"""
from __future__ import annotations

import dataclasses

from cbench import weights

ITEMS = "images"
#: the configuration and traffic keys a CPU test overrides: a size at
#: which a step runs in a second there
TINY = dict(stage_sizes=[1, 1, 1, 1], width=8, n_classes=16, img_size=32)
TINY_TRAFFIC = dict(global_batch=8)


def blocks(cfg: dict):
    """``(stage, block, cin, width, stride)`` of every bottleneck."""
    cin = cfg["width"]
    for s, n in enumerate(cfg["stage_sizes"]):
        width = cfg["width"] * 2 ** s
        for b in range(n):
            yield s, b, cin, width, 2 if (b == 0 and s > 0) else 1
            cin = width * 4


def leaf_specs(cfg: dict) -> list:
    """``(name, shape, mean, std)`` of every leaf: He-normal kernels,
    BatchNorm scales at 0.02 around 1 (the last of each block around the
    configuration's ``bn3_scale``) and biases at 0.02, the head at 0.01
    and its bias at 0.02."""
    def conv(name, k, cin, cout):
        return (name, (k, k, cin, cout), 0.0, (2.0 / (k * k * cin)) ** 0.5)

    def bn(name, ch, scale=1.0):
        return [(name + ".bias", (ch,), 0.0, 0.02),
                (name + ".scale", (ch,), scale, 0.02)]

    w = cfg["width"]
    specs = [conv("stem", 7, 3, w), *bn("bn_stem", w)]
    cin = w
    for s, b, cin, width, stride in blocks(cfg):
        p = f"stages.{s}.{b}."
        specs += [conv(p + "conv1", 1, cin, width), *bn(p + "bn1", width),
                  conv(p + "conv2", 3, width, width), *bn(p + "bn2", width),
                  conv(p + "conv3", 1, width, width * 4),
                  *bn(p + "bn3", width * 4, cfg["bn3_scale"])]
        if stride != 1 or cin != width * 4:
            specs += [conv(p + "proj", 1, cin, width * 4),
                      *bn(p + "bn_proj", width * 4)]
        cin = width * 4
    specs += [("head", (cin, cfg["n_classes"]), 0.0, 0.01),
              ("head_b", (cfg["n_classes"],), 0.0, 0.02)]
    return specs


def port_configs(cfg: dict, traffic: dict):
    """``(ResNetConfig, OptConfig)`` of the port."""
    from repro_torch.configs.resnet50 import ResNetConfig
    from repro_torch.train.optimizer import OptConfig
    names = {f.name for f in dataclasses.fields(ResNetConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    kw["stage_sizes"] = tuple(kw["stage_sizes"])
    onames = {f.name for f in dataclasses.fields(OptConfig)}
    oc = OptConfig(**{k: v for k, v in cfg["optimizer"].items()
                      if k in onames}, master_dtype=cfg["master_dtype"])
    return ResNetConfig(**kw), oc


class Program:
    """The port's ResNet train step with its params and optimizer
    state."""

    def __init__(self, cfg: dict, traffic: dict, named: dict, device):
        from repro_torch.train.optimizer import opt_init
        from repro_torch.train.step import make_resnet_train_step
        c, oc = port_configs(cfg, traffic)
        self.params = weights.nest(named)
        self.opt_state = opt_init(oc, self.params)
        self._step = make_resnet_train_step(c, oc)

    def step(self, batch: dict) -> dict:
        self.params, self.opt_state, m = self._step(self.params,
                                                    self.opt_state, batch)
        return m

    def first_moments(self) -> dict:
        return weights.flat(self.opt_state["m"])

    def masters(self) -> dict:
        return weights.flat(self.opt_state["master"])
