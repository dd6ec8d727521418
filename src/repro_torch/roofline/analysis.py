"""Three-term roofline model of a dry-run cell on one H100.

Port of ``src/repro/roofline/analysis.py``:

  compute term    = FLOPs_per_device / peak FLOP/s of one card
  memory term     = bytes_per_device / HBM bandwidth of one card
  collective term = wire_bytes_per_device / link bandwidth of one card

The reference's constants are one TPU v5e's; these are one NVIDIA H100
SXM's (NVIDIA's data sheet, dense rates, at the 700 W power limit), the
figures PERF.md uses. Each is a keyword argument of :func:`analyze`, so
the reference's model can be evaluated with its own constants.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS_BF16 = 989e12         # FLOP/s, bf16 dense on the tensor cores
HBM_BW = 3.35e12                 # B/s, HBM3
# NVLink 4: 18 links of 50 GB/s both ways together, 450 GB/s each way per
# card. One card moves no collective bytes, so its term is 0 s.
LINK_BW = 450e9                  # B/s


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # 6*N*D (dense) or 6*N_active*D
    useful_flops_ratio: float    # MODEL_FLOPS/chips / counted FLOPs
    step_time_s: float           # max of the three terms
    roofline_fraction: float     # compute_s / step_time_s (MFU-like bound)

    def to_dict(self):
        return asdict(self)


def model_flops(c: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D for training; 2*N*D for inference (fwd only)."""
    n = c.active_param_count()
    d = shape.tokens_per_step
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d


def analyze(c: ModelConfig, shape: ShapeConfig, *, mesh_name: str,
            n_devices: int, flops_per_device: float,
            hbm_bytes_per_device: float, wire_bytes_per_device: float,
            peak_flops: float = PEAK_FLOPS_BF16, hbm_bw: float = HBM_BW,
            link_bw: float = LINK_BW) -> Roofline:
    compute_s = flops_per_device / peak_flops
    memory_s = hbm_bytes_per_device / hbm_bw
    coll_s = wire_bytes_per_device / link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(c, shape)
    useful = (mf / n_devices) / max(flops_per_device, 1.0)
    step = max(terms.values())
    return Roofline(
        arch=c.name, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=flops_per_device,
        hbm_bytes_per_device=hbm_bytes_per_device,
        wire_bytes_per_device=wire_bytes_per_device,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck=bottleneck, model_flops=mf, useful_flops_ratio=useful,
        step_time_s=step,
        roofline_fraction=compute_s / step if step > 0 else 0.0)
