"""The card: the look for it, its published peaks, and NVML's energy
counter.

``NvmlCounter`` is a copy of the port's ``power.methods.NvmlEnergy``
(``nvmlDeviceGetTotalEnergyConsumption`` through ``ctypes``, mJ since
the NVIDIA kernel module loaded), kept here so that the yardstick does
not move with the program; it also reads the enforced power limit. It
opens the card by the UUID that CUDA gives the run's device, since NVML
numbers the cards of the machine and ignores ``CUDA_VISIBLE_DEVICES``;
a run whose card NVML does not list fails. The counter advances about
every 100 ms, so :meth:`NvmlCounter.edge` waits for its next step and
returns the step's time and value: a window between two edges has its
energy exactly, up to the counter's own resolution.
"""
from __future__ import annotations

import ctypes
import time

import torch

#: published dense peaks (NVIDIA's data sheets) by the name the card
#: reports; an H100 of another form factor takes the SXM part's
PEAKS = {
    "H100": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict:
    for key, val in PEAKS.items():
        if key in kind:
            return val
    raise KeyError(f"no published peaks for {kind!r}")


class NoCard(RuntimeError):
    """The run asked for more cards than the machine has."""


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark "
                     "runs on the card only")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell needs {n} card(s), the machine has {have}")


def cuda_uuid(device: int = 0) -> str:
    """The UUID of CUDA device ``device`` as this process numbers it."""
    return str(torch.cuda.get_device_properties(device).uuid)


def _hex(uuid: str) -> str:
    """A UUID's 32 hex digits, lower case: NVML writes ``GPU-`` before
    them, CUDA does not."""
    digits = uuid.lower().removeprefix("gpu-").replace("-", "")
    if len(digits) != 32:
        raise ValueError(f"not a card's UUID: {uuid!r}")
    return digits


class NvmlCounter:
    """The cumulative energy (joules) and power limit (W) of the card
    whose UUID is ``uuid`` (:func:`cuda_uuid`); ``lib`` stands in for
    NVML's library in tests."""

    def __init__(self, uuid: str, lib=None):
        lib = lib if lib is not None else ctypes.CDLL("libnvidia-ml.so.1")
        lib.nvmlErrorString.restype = ctypes.c_char_p
        lib.nvmlErrorString.argtypes = [ctypes.c_int]
        for fn, args in (
                ("nvmlInit_v2", []),
                ("nvmlShutdown", []),
                ("nvmlDeviceGetCount_v2", [ctypes.POINTER(ctypes.c_uint)]),
                ("nvmlDeviceGetHandleByIndex_v2",
                 [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]),
                ("nvmlDeviceGetUUID",
                 [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
                ("nvmlDeviceGetEnforcedPowerLimit",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        self._lib = lib
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = self._find(_hex(uuid))

    def _find(self, want: str) -> ctypes.c_void_p:
        """The handle of the card whose UUID has the hex digits
        ``want``; ``RuntimeError`` if NVML lists none."""
        lib, n = self._lib, ctypes.c_uint()
        self._check(lib.nvmlDeviceGetCount_v2(ctypes.byref(n)),
                    "nvmlDeviceGetCount_v2")
        seen = []
        for i in range(n.value):
            handle, buf = ctypes.c_void_p(), ctypes.create_string_buffer(96)
            self._check(lib.nvmlDeviceGetHandleByIndex_v2(
                i, ctypes.byref(handle)), "nvmlDeviceGetHandleByIndex_v2")
            self._check(lib.nvmlDeviceGetUUID(handle, buf, len(buf)),
                        "nvmlDeviceGetUUID")
            seen.append(buf.value.decode())
            if _hex(seen[-1]) == want:
                return handle
        lib.nvmlShutdown()
        raise RuntimeError(f"NVML lists no card with the UUID {want} of "
                           f"the run's device (it lists {seen})")

    def _check(self, ret: int, what: str) -> None:
        if ret != 0:
            msg = self._lib.nvmlErrorString(ret).decode()
            raise RuntimeError(f"{what} failed: NVML error {ret} ({msg})")

    def joules(self) -> float:
        mj = ctypes.c_ulonglong()
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value / 1000.0

    def power_limit_w(self) -> float:
        mw = ctypes.c_uint()
        self._check(self._lib.nvmlDeviceGetEnforcedPowerLimit(
            self._handle, ctypes.byref(mw)),
            "nvmlDeviceGetEnforcedPowerLimit")
        return mw.value / 1000.0

    def edge(self, timeout_s: float = 0.5) -> tuple[float, float]:
        """``(perf_counter time, joules)`` at the counter's next step (or
        after ``timeout_s`` if it does not step)."""
        j0 = self.joules()
        end = time.perf_counter() + timeout_s
        while True:
            t, j = time.perf_counter(), self.joules()
            if j != j0 or t > end:
                return t, j
            time.sleep(0.0005)

    def close(self) -> None:
        self._check(self._lib.nvmlShutdown(), "nvmlShutdown")
