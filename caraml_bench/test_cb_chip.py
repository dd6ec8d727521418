"""NVML's energy counter opened by the run's card's UUID, with a stubbed
NVML library, on the CPU."""
import ctypes
import types

import pytest

from cbench import chip

UUIDS = ["GPU-aaaaaaaa-0000-1111-2222-333333333333",
         "GPU-bbbbbbbb-4444-5555-6666-777777777777"]


class StubNvml:
    """NVML over two cards: card i's counter reads (i + 1) * 1000 mJ and
    its limit (i + 1) * 100 W. Handles are 100 + index."""

    def __init__(self, uuids=UUIDS):
        self.uuids, self.shut = uuids, 0

    def lib(self):
        """The functions as ctypes gives them: plain functions, which
        take ``argtypes`` and ``restype``."""
        def plain(method):
            return lambda *args: method(*args)
        return types.SimpleNamespace(**{
            n: plain(getattr(self, n)) for n in dir(self)
            if n.startswith("nvml")})

    def nvmlErrorString(self, ret):
        return b"stub error"

    def nvmlInit_v2(self):
        return 0

    def nvmlShutdown(self):
        self.shut += 1
        return 0

    def nvmlDeviceGetCount_v2(self, n):
        n._obj.value = len(self.uuids)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, handle):
        handle._obj.value = 100 + i
        return 0

    def nvmlDeviceGetUUID(self, handle, buf, size):
        ctypes.memmove(buf, self.uuids[handle.value - 100].encode(), 41)
        return 0

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, mj):
        mj._obj.value = (handle.value - 99) * 1000
        return 0

    def nvmlDeviceGetEnforcedPowerLimit(self, handle, mw):
        mw._obj.value = (handle.value - 99) * 100_000
        return 0


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("form", ["cuda", "nvml"])
def test_counter_opens_the_card_with_the_runs_uuid(index, form):
    uuid = UUIDS[index]
    if form == "cuda":              # as torch prints it: no GPU- prefix
        uuid = uuid.removeprefix("GPU-")
    c = chip.NvmlCounter(uuid, lib=StubNvml().lib())
    assert c.joules() == index + 1
    assert c.power_limit_w() == 100 * (index + 1)


def test_counter_fails_when_nvml_lists_no_such_card():
    lib = StubNvml()
    with pytest.raises(RuntimeError, match="no card with the UUID"):
        chip.NvmlCounter("cccccccc-0000-0000-0000-000000000000",
                         lib=lib.lib())
    assert lib.shut == 1


def test_a_uuid_that_is_not_one_is_refused():
    with pytest.raises(ValueError):
        chip.NvmlCounter("0", lib=StubNvml().lib())
