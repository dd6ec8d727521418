"""Power-measurement methods (jpwr's pluggable backend architecture).

Port of ``src/repro/power/methods.py``. Each method exposes
``read() -> dict[device_name, value]``; its ``kind`` says what the value
is:

  nvml_energy — ``kind="energy"``: the card's cumulative energy counter
                through NVML (``nvmlDeviceGetTotalEnergyConsumption``,
                mJ counted since the NVIDIA kernel module loaded), in
                joules. A window's energy is the counter's difference
                across it
                (``core.metrics.counter_energy_wh``). The default
                (``--power auto``), as the reference's ``auto`` prefers
                its RAPL energy counter;
  nvml        — ``kind="power"``: the board power reading through NVML
                (``nvmlDeviceGetPowerUsage``), in watts. On Ampere (but
                GA100) and newer cards NVML documents it as an average
                over one second, so integrating it over windows of tens
                of ms smears each window's energy over its neighbours;
                kept as an explicit choice for comparison;
  synthetic   — ``kind="power"``: deterministic waveform, for tests;
                used only when asked for, and labelled ``synthetic``.

Both NVML methods call ``libnvidia-ml.so.1`` (installed with the card's
software) via ``ctypes``: the counterpart of jpwr's pynvml method and
the port's replacement for the reference's analytic TPU model. A
measured backend that cannot be opened, or whose call fails, raises; it
never falls back to another reading. The reference's RAPL and analytic
TPU backends have no port (the TPU model is TPU-specific).
"""
from __future__ import annotations

import ctypes
import time
from typing import Callable

import torch


class PowerMethod:
    name = "base"
    #: what ``read`` returns: ``"power"`` (watts, as the device reports
    #: them at the call: instantaneous or averaged, per the backend) or
    #: ``"energy"`` (a cumulative counter in joules, which may advance in
    #: steps)
    kind = "power"

    def devices(self) -> list[str]:
        raise NotImplementedError

    def read(self) -> dict[str, float]:
        """One reading per device: watts for ``kind == "power"``,
        cumulative joules for ``kind == "energy"``."""
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
    (milliwatts, the board's own sensor; a one-second average on recent
    cards). Raises ``RuntimeError`` when the library cannot be opened or
    a call fails."""

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
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)])):
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


class NvmlEnergy(NvmlPower):
    """Cumulative energy of one NVIDIA card from
    ``nvmlDeviceGetTotalEnergyConsumption`` (an unsigned 64-bit count of
    mJ counted since the NVIDIA kernel module loaded; Volta and newer),
    read in joules. The counter advances in steps, so a reading is the
    energy up to the card's last update. Raises ``RuntimeError`` when a
    call fails."""

    name = "nvml_energy"
    kind = "energy"

    def read(self):
        mj = ctypes.c_ulonglong()
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return {self.devices()[0]: mj.value / 1000.0}


#: the ``--power`` choices of the port's bench CLI
POWER_CHOICES = ("auto", "nvml", "synthetic", "none")


def select_power_methods(prefer: str, device: torch.device, *,
                         n_devices: int = 1,
                         ) -> tuple[list[PowerMethod], str]:
    """The measurement backend for a run on ``device``, as
    ``(methods, source_label)``; the label is stamped into every result
    record as ``power_source``.

    Port of ``select_power_methods`` (``src/repro/power/methods.py``):
    ``"auto"`` reads the card's energy counter through NVML (labelled
    ``nvml_energy``), as the reference's ``auto`` prefers an energy
    counter; ``"nvml"`` reads the board power reading instead (labelled
    ``nvml``, for comparison); both raise when the run is not on a card
    or NVML cannot be opened. ``"synthetic"`` is the labelled waveform;
    ``"none"`` measures nothing. Nothing is substituted silently.
    """
    if prefer == "none":
        return [], "none"
    if prefer == "synthetic":
        return [SyntheticPower(n_devices=n_devices)], "synthetic"
    if prefer in ("auto", "nvml"):
        if device.type != "cuda":
            raise RuntimeError(
                f"--power {prefer} measures a card's board power, but the "
                f"run is on {device}; pass --power none (or synthetic)")
        if prefer == "nvml":
            return [NvmlPower(device.index or 0)], "nvml"
        return [NvmlEnergy(device.index or 0)], "nvml_energy"
    raise KeyError(f"unknown power method {prefer!r}; known: "
                   f"{list(POWER_CHOICES)}")
