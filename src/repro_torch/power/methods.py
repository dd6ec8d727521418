"""Power-measurement methods (jpwr's pluggable backend architecture).

Port of ``src/repro/power/methods.py``. Each method exposes
``read() -> dict[device_name, watts]``:

  nvml       — the card's own power reading through NVML
               (``libnvidia-ml.so.1``, installed with the card's
               software, called via ``ctypes``): the counterpart of
               jpwr's pynvml method and the port's replacement for the
               reference's analytic TPU model;
  synthetic  — deterministic waveform, for tests; used only when asked
               for, and labelled ``synthetic``.

A measured backend that cannot be opened raises; it never falls back to
a synthetic reading. The reference's RAPL and analytic TPU backends have
no port (the TPU model is TPU-specific).
"""
from __future__ import annotations

import ctypes
import time
from typing import Callable

import torch


class PowerMethod:
    name = "base"

    def devices(self) -> list[str]:
        raise NotImplementedError

    def read(self) -> dict[str, float]:
        """Instantaneous power per device, in watts."""
        raise NotImplementedError


class SyntheticPower(PowerMethod):
    """Deterministic device power: P(t) = base + amp * tri(t/period)."""

    name = "synthetic"

    def __init__(self, n_devices: int = 1, base: float = 100.0,
                 amp: float = 0.0, period: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.n, self.base, self.amp, self.period = n_devices, base, amp, period
        self.clock = clock
        self._t0 = clock()

    def devices(self):
        return [f"synthetic:{i}" for i in range(self.n)]

    def read(self):
        t = (self.clock() - self._t0) / self.period
        tri = abs(2 * (t - int(t)) - 1)  # triangle wave in [0, 1]
        p = self.base + self.amp * tri
        return {d: p for d in self.devices()}


class NvmlPower(PowerMethod):
    """Board power of one NVIDIA card from ``nvmlDeviceGetPowerUsage``
    (milliwatts, the board's own sensor). Raises ``RuntimeError`` when
    the library cannot be opened or a call fails."""

    name = "nvml"

    def __init__(self, index: int = 0,
                 lib_path: str = "libnvidia-ml.so.1"):
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError as e:
            raise RuntimeError(f"NVML library {lib_path!r} cannot be "
                               f"opened: {e}") from e
        lib.nvmlErrorString.restype = ctypes.c_char_p
        lib.nvmlErrorString.argtypes = [ctypes.c_int]
        for fn, args in (
                ("nvmlInit_v2", []),
                ("nvmlShutdown", []),
                ("nvmlDeviceGetHandleByIndex_v2",
                 [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]),
                ("nvmlDeviceGetPowerUsage",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        self._lib = lib
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = ctypes.c_void_p()
        self._check(lib.nvmlDeviceGetHandleByIndex_v2(
            index, ctypes.byref(self._handle)), "nvmlDeviceGetHandleByIndex_v2")
        self.index = index

    def _check(self, ret: int, what: str) -> None:
        if ret != 0:
            msg = self._lib.nvmlErrorString(ret).decode()
            raise RuntimeError(f"{what} failed: NVML error {ret} ({msg})")

    def devices(self):
        return [f"nvml:{self.index}"]

    def read(self):
        mw = ctypes.c_uint()
        self._check(self._lib.nvmlDeviceGetPowerUsage(
            self._handle, ctypes.byref(mw)), "nvmlDeviceGetPowerUsage")
        return {self.devices()[0]: mw.value / 1000.0}

    def close(self) -> None:
        self._check(self._lib.nvmlShutdown(), "nvmlShutdown")


#: the ``--power`` choices of the port's bench CLI
POWER_CHOICES = ("auto", "synthetic", "none")


def select_power_methods(prefer: str, device: torch.device, *,
                         n_devices: int = 1,
                         ) -> tuple[list[PowerMethod], str]:
    """The measurement backend for a run on ``device``, as
    ``(methods, source_label)``; the label is stamped into every result
    record as ``power_source``.

    Port of ``select_power_methods`` (``src/repro/power/methods.py``):
    ``"auto"`` reads the card's board power through NVML (labelled
    ``nvml``) and raises when the run is not on a card or NVML cannot be
    opened; ``"synthetic"`` is the labelled waveform; ``"none"`` measures
    nothing. Nothing is substituted silently.
    """
    if prefer == "none":
        return [], "none"
    if prefer == "synthetic":
        return [SyntheticPower(n_devices=n_devices)], "synthetic"
    if prefer == "auto":
        if device.type != "cuda":
            raise RuntimeError(
                f"--power auto measures a card's board power, but the run "
                f"is on {device}; pass --power none (or synthetic)")
        return [NvmlPower(device.index or 0)], "nvml"
    raise KeyError(f"unknown power method {prefer!r}; known: "
                   f"{list(POWER_CHOICES)}")
