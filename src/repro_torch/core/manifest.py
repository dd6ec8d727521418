"""Reproducibility manifest — CARAML's automation records exactly what ran.

Port of ``src/repro/core/manifest.py``: where the reference records JAX's
version, backend and device count, this records PyTorch's version, its
CUDA version, the device the run used and the card count.
"""
from __future__ import annotations

import functools
import json
import pathlib
import platform
import subprocess
import sys
import time

import torch


@functools.lru_cache(maxsize=1)
def git_sha() -> str | None:
    """Commit of the tree being benchmarked, or None outside a checkout.

    Stamped into every manifest and ResultRecord so cross-run comparison
    can always answer *which code* produced each side of a delta.
    """
    try:
        proc = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=pathlib.Path(__file__).resolve().parent)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = proc.stdout.strip()
    return sha if proc.returncode == 0 and sha else None


def build_manifest(device: torch.device, extra: dict | None = None) -> dict:
    cuda = device.type == "cuda"
    m = {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "git_sha": git_sha(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 0,
        "platform": platform.platform(),
        "argv": sys.argv,
    }
    if extra:
        m.update(extra)
    return m


def write_manifest(out_dir, device: torch.device,
                   extra: dict | None = None) -> dict:
    m = build_manifest(device, extra)
    p = pathlib.Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    (p / "manifest.json").write_text(json.dumps(m, indent=1, default=str))
    return m
