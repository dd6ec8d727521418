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
  rapl        — ``kind="power"``: the host's Linux powercap (intel-rapl)
                energy counters as watts (the reference's backend and
                the analog of jpwr's hwmon-sysfs method): the host CPU's
                packages, not the card; only when asked for
                (``--power rapl``), and raising when no zone is
                readable;
  synthetic   — ``kind="power"``: deterministic waveform, for tests;
                used only when asked for, and labelled ``synthetic``.

Both NVML methods call ``libnvidia-ml.so.1`` (installed with the card's
software) via ``ctypes``: the counterpart of jpwr's pynvml method and
the port's replacement for the reference's analytic TPU model. A
measured backend that cannot be opened, or whose call fails, raises; it
never falls back to another reading unless the caller wraps it in
:class:`FallbackPower`, which labels every record it touched. The
reference's analytic TPU backend (``TPUModelPower``, fed by
``power/utilization.py``) has no port by design: it models a TPU.
"""
from __future__ import annotations

import ctypes
import os
import time
from typing import Callable, Optional

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

    def available(self) -> bool:
        return True


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


class RaplPower(PowerMethod):
    """Linux powercap (intel-rapl) sysfs energy counters -> watts.

    Copy of the reference's: a zone's first read has no baseline and
    reads 0.0, a later one the counter's difference over the time since
    the previous read, and a counter that wrapped (went down) counts its
    post-wrap value. The zones are the host's, not the card's."""

    name = "rapl"
    ROOT = "/sys/class/powercap"

    def __init__(self, root: Optional[str] = None):
        self.root = root or self.ROOT
        self._zones = []
        if os.path.isdir(self.root):
            for z in sorted(os.listdir(self.root)):
                p = os.path.join(self.root, z, "energy_uj")
                if os.path.exists(p):
                    self._zones.append((z, p))
        self._last: dict[str, tuple[float, float]] = {}

    def available(self) -> bool:
        if not self._zones:
            return False
        try:
            with open(self._zones[0][1]) as f:
                f.read()
            return True
        except OSError:
            return False

    def devices(self):
        return [z for z, _ in self._zones]

    def read(self):
        out = {}
        now = time.monotonic()
        for z, p in self._zones:
            try:
                with open(p) as f:
                    uj = float(f.read().strip())
            except OSError:
                continue
            if z in self._last:
                uj0, t0 = self._last[z]
                dt = max(now - t0, 1e-6)
                d_uj = uj - uj0
                if d_uj < 0:  # counter wrap
                    d_uj = uj
                out[z] = d_uj / dt / 1e6
            else:
                out[z] = 0.0
            self._last[z] = (uj, now)
        return out


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


class FallbackPower(PowerMethod):
    """Resilience wrapper: a primary backend whose ``read()`` failures
    fall back to a second method instead of crashing (or silently
    zeroing) the measurement.

    Port of the reference's. Column stability: ``name``/``devices()``
    and ``kind`` are the PRIMARY's — ``MeasuredScope`` builds its frame
    columns (and marks counter columns) once at entry, so the wrapper
    must look like the primary forever. Fallback readings are remapped
    onto the primary's device names (the total split evenly). After
    ``max_failures`` consecutive primary failures the wrapper stops
    poking the dead backend (``degraded``). ``label`` reports
    ``"<primary>+fallback:<name>"`` once any fallback reading was used,
    so records never pass a substituted reading off as the primary's.

    What the reference does not need: the port's methods come in two
    kinds (``NvmlEnergy`` counts joules, ``NvmlPower`` reads watts). An
    energy primary may fall back to a power method: the wrapper then
    reads the fallback beside every good primary read (at ``clock()``),
    and a fallback reading is the last value returned plus the trapezoid
    of the fallback's watts since its previous read, so the column stays
    one cumulative counter. When the primary comes back, the column
    takes its counter again (exact across the gap); if it never read
    before, the column is shifted to stay continuous. A power primary
    takes a power fallback only (ValueError otherwise).
    """

    def __init__(self, primary: PowerMethod, fallback: PowerMethod,
                 max_failures: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if primary.kind == "power" and fallback.kind == "energy":
            raise ValueError("a power primary takes a power fallback: "
                             "joules cannot stand in for watts")
        self.primary, self.fallback = primary, fallback
        self.name = primary.name
        self.kind = primary.kind
        self.max_failures = max(1, int(max_failures))
        self.failures = 0           # consecutive primary read failures
        self.fallback_reads = 0
        self.degraded = False
        self.clock = clock
        #: an energy primary over a power fallback
        self._convert = fallback.kind != self.kind
        self._fb_last: Optional[tuple[float, float]] = None  # (t, total)
        self._last: Optional[dict] = None   # the last value returned
        self._offset: Optional[dict] = None  # energy primary: shift
        self._primary_read = False

    @property
    def label(self) -> str:
        if self.fallback_reads:
            return f"{self.primary.name}+fallback:{self.fallback.name}"
        return self.primary.name

    def devices(self):
        return self.primary.devices()

    def available(self) -> bool:
        return self.primary.available() or self.fallback.available()

    def _fallback_total(self) -> Optional[tuple[float, float]]:
        """Read the fallback: ``_fb_last`` becomes this read's ``(t,
        total)``; returns the previous one."""
        vals = self.fallback.read()
        prev, self._fb_last = self._fb_last, (self.clock(),
                                              sum(vals.values()))
        return prev

    def _converted(self, prev) -> dict:
        """The fallback's last read in the primary's kind, per primary
        device (``prev`` is the fallback's read before it)."""
        t, total = self._fb_last
        devs = self.primary.devices()
        n = max(len(devs), 1)
        if not self._convert:
            return {d: total / n for d in devs}
        # the fallback's watts -> the primary's joules
        add = 0.0 if prev is None else 0.5 * (prev[1] + total) * (t - prev[0])
        base = self._last or dict.fromkeys(devs, 0.0)
        return {d: base[d] + add / n for d in devs}

    def _read_fallback(self) -> dict:
        self.fallback_reads += 1
        self._last = self._converted(self._fallback_total())
        return self._last

    def _read_primary(self) -> dict:
        out = self.primary.read()
        if self._convert:
            try:
                prev = self._fallback_total()
            except Exception:  # noqa: BLE001 - the primary's read stands
                prev = self._fb_last = None
            if not self._primary_read and self._last is not None:
                # first good read after fallback-only readings: shift the
                # counter to continue the column
                want = (self._converted(prev) if self._fb_last is not None
                        else self._last)
                self._offset = {d: want[d] - out[d] for d in out}
            if self._offset:
                out = {d: v + self._offset[d] for d, v in out.items()}
        self._primary_read = True
        self._last = out
        return out

    def read(self) -> dict:
        if self.degraded:
            return self._read_fallback()
        try:
            out = self._read_primary()
            self.failures = 0
            return out
        except Exception:  # noqa: BLE001 - a dead backend must not crash
            self.failures += 1
            if self.failures >= self.max_failures:
                self.degraded = True
            return self._read_fallback()


METHODS = {"synthetic": SyntheticPower, "rapl": RaplPower,
           "nvml": NvmlPower, "nvml_energy": NvmlEnergy}


def get_method(name: str, **kw) -> PowerMethod:
    return METHODS[name](**kw)


#: the ``--power`` choices of the port's bench CLI
POWER_CHOICES = ("auto", "nvml", "rapl", "synthetic", "none")


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
    or NVML cannot be opened. ``"rapl"`` reads the host's powercap
    counters and raises when no zone is readable (the reference then
    reads zero). ``"synthetic"`` is the labelled waveform; ``"none"``
    measures nothing. Nothing is substituted silently.
    """
    if prefer == "none":
        return [], "none"
    if prefer == "synthetic":
        return [SyntheticPower(n_devices=n_devices)], "synthetic"
    if prefer == "rapl":
        rapl = RaplPower()
        if not rapl.available():
            raise RuntimeError(
                f"--power rapl reads the host's powercap counters, but no "
                f"zone under {rapl.root} is readable; pass --power auto "
                f"(the card's energy counter), none or synthetic")
        return [rapl], "rapl"
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
