"""ResNet50 — the paper's computer-vision benchmark case (Fig. 3/4, Table III).

Copy of ``src/repro/configs/resnet50.py``. Not an LM; described by its
own small config record. ``RESNET18`` and ``RESNET34`` are the
reference's: they keep its bottleneck blocks (``models/resnet.py`` has
no basic block), so they are not the published 18- and 34-layer nets.
"""
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet50"
    stage_sizes: tuple = (3, 4, 6, 3)      # ResNet50 bottleneck stages
    width: int = 64
    n_classes: int = 1000
    img_size: int = 224
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    def reduced(self, **overrides) -> "ResNetConfig":
        small = dict(stage_sizes=(1, 1, 1, 1), width=8, n_classes=16,
                     img_size=32, name=self.name + "-reduced")
        small.update(overrides)
        return replace(self, **small)


CONFIG = ResNetConfig()
RESNET18 = ResNetConfig(name="resnet18", stage_sizes=(2, 2, 2, 2))
RESNET34 = ResNetConfig(name="resnet34", stage_sizes=(3, 4, 6, 3))
