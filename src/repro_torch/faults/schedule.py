"""Seeded fault schedules: typed fault events, bit-reproducible by
``(preset, seed)``.

Copy of ``src/repro/faults/schedule.py`` (numpy and the standard
library only), ``corrupt_checkpoint``'s import rewritten to the port's
``ckpt``: the same ``(preset, seed)`` gives the reference's events and
``schedule_hash``.

A :class:`FaultSchedule` is built once from a named preset and a seed,
then threaded into the training loop (crash / device loss / slowdown /
checkpoint corruption), the serve engine (slot faults / admission
overload), and the power layer (backend read failures). The schedule is
pure data — event placement is drawn from a ``numpy`` Generator seeded
from ``(seed, sha1(preset))`` — and its canonical-JSON sha1 is stamped
into every benchmark record (``schedule_hash``, mirroring the traffic
subsystem's ``trace_hash``) so a regression report names the exact
failure story it was measured under.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np


class InjectedFault(RuntimeError):
    """Base for scheduled faults. ``transient`` marks them retryable to
    the error classifier in ``core.runner``."""

    transient = True


class InjectedCrash(InjectedFault):
    """Process crash at a training step (1-indexed, post-step)."""

    def __init__(self, step: int):
        super().__init__(f"injected failure at step {step}")
        self.step = step


class DeviceLoss(InjectedFault):
    """Loss of ``n_lost`` devices at a training step — the supervisor
    answers with an elastic rescale, not a plain restart."""

    def __init__(self, step: int, n_lost: int):
        super().__init__(f"injected loss of {n_lost} device(s) "
                         f"at step {step}")
        self.step = step
        self.n_lost = n_lost


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``kind``: crash | device_loss | ckpt_corrupt | slowdown | power_fail
    (train side, ``at`` is a 1-indexed step) or slot_fault | overload
    (serve side, ``at`` indexes decode dispatches / admission polls).
    ``n`` is kind-specific (devices lost, queue cap, failed reads);
    ``seconds`` is the per-step slowdown; ``span`` is how many
    steps/polls the event covers.
    """

    kind: str
    at: int
    n: int = 0
    seconds: float = 0.0
    span: int = 1


#: train-side presets (resilience workload axis values)
TRAIN_PRESETS = ("none", "crash_mid", "crash_double", "ckpt_corrupt",
                 "device_loss", "flaky", "power_fail")
#: serve-side presets
SERVE_PRESETS = ("none", "overload", "decode_fault")

_CRASH_KINDS = ("crash", "device_loss", "ckpt_corrupt")


def _preset_rng(preset: str, seed: int) -> np.random.Generator:
    tag = int.from_bytes(hashlib.sha1(preset.encode()).digest()[:4], "little")
    return np.random.default_rng(np.random.SeedSequence([int(seed), tag]))


class FaultSchedule:
    """An immutable event list plus a small amount of firing state.

    Crash-class events fire at most once per schedule *object*: the
    supervisor shares one schedule across restarts of the same run, so
    a crash scheduled at step 12 kills the first attempt and lets the
    resumed attempt sail past step 12.
    """

    def __init__(self, preset: str, seed: int, total_steps: int,
                 events: tuple):
        self.preset = preset
        self.seed = int(seed)
        self.total_steps = int(total_steps)
        self.events = tuple(events)
        self.fired: set = set()  # indices of one-shot events already fired

    # -- construction -----------------------------------------------------
    @classmethod
    def from_preset(cls, preset: str, seed: int = 0,
                    total_steps: int = 100) -> "FaultSchedule":
        if preset not in TRAIN_PRESETS + SERVE_PRESETS:
            raise ValueError(
                f"unknown fault preset {preset!r}; train presets: "
                f"{TRAIN_PRESETS}, serve presets: {SERVE_PRESETS}")
        rng = _preset_rng(preset, seed)
        mid = max(2, total_steps // 2)
        jit = lambda lo, hi: int(rng.integers(lo, hi + 1))  # noqa: E731
        ev: list[FaultEvent] = []
        if preset == "crash_mid":
            ev.append(FaultEvent("crash", at=mid + jit(-2, 2)))
        elif preset == "crash_double":
            a = max(2, total_steps // 3 + jit(-2, 2))
            b = max(a + 2, 2 * total_steps // 3 + jit(-2, 2))
            ev += [FaultEvent("crash", at=a), FaultEvent("crash", at=b)]
        elif preset == "ckpt_corrupt":
            ev.append(FaultEvent("ckpt_corrupt", at=mid + jit(-2, 2)))
        elif preset == "device_loss":
            ev.append(FaultEvent("device_loss", at=mid + jit(-2, 2),
                                 n=max(1, jit(1, 4))))
        elif preset == "flaky":
            k = 3
            steps = sorted(int(s) for s in rng.choice(
                np.arange(2, max(3, total_steps)), size=k, replace=False))
            ev += [FaultEvent("slowdown", at=s,
                              seconds=round(0.01 + 0.02 * rng.random(), 4))
                   for s in steps]
        elif preset == "power_fail":
            ev.append(FaultEvent("power_fail", at=jit(2, max(3, mid)),
                                 n=jit(2, 5)))
        elif preset == "overload":
            start = jit(3, 8)
            ev.append(FaultEvent("overload", at=start, n=jit(2, 4),
                                 span=jit(4, 8)))
        elif preset == "decode_fault":
            ev.append(FaultEvent("slot_fault", at=jit(4, 12)))
        # "none": empty event list — the fault-free twin shares the
        # schedule machinery (and hash stamping) with the faulted cells.
        return cls(preset, seed, total_steps, tuple(ev))

    # -- identity ---------------------------------------------------------
    def canonical(self) -> dict:
        return {"preset": self.preset, "seed": self.seed,
                "total_steps": self.total_steps,
                "events": [asdict(e) for e in self.events]}

    @property
    def schedule_hash(self) -> str:
        blob = json.dumps(self.canonical(), sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    # -- train-side queries (1-indexed steps) -----------------------------
    def crash_at(self, step: int) -> Optional[FaultEvent]:
        """The one-shot crash-class event due at ``step`` (or earlier,
        if a resume skipped past it), if it hasn't fired yet."""
        for i, e in enumerate(self.events):
            if e.kind in _CRASH_KINDS and i not in self.fired and e.at <= step:
                self.fired.add(i)
                return e
        return None

    def slowdown_s(self, step: int) -> float:
        return sum(e.seconds for e in self.events
                   if e.kind == "slowdown" and e.at <= step < e.at + e.span)

    def power_fail_window(self) -> Optional[tuple]:
        """(first failing read index, n failed reads) or None."""
        for e in self.events:
            if e.kind == "power_fail":
                return (e.at, max(1, e.n))
        return None

    # -- serve-side queries (dispatch/poll indices, 0-indexed) ------------
    def queue_cap_at(self, poll: int) -> Optional[int]:
        """Admission-queue cap during an overload window, else None."""
        for e in self.events:
            if e.kind == "overload" and e.at <= poll < e.at + e.span:
                return max(1, e.n)
        return None

    def slot_fault_at(self, decode_idx: int) -> bool:
        """True exactly once per scheduled slot fault."""
        for i, e in enumerate(self.events):
            if (e.kind == "slot_fault" and i not in self.fired
                    and e.at <= decode_idx):
                self.fired.add(i)
                return True
        return False

    def __repr__(self) -> str:
        return (f"FaultSchedule({self.preset!r}, seed={self.seed}, "
                f"hash={self.schedule_hash}, events={len(self.events)})")


def corrupt_checkpoint(ckpt_dir, step: Optional[int] = None) -> Optional[int]:
    """Deterministically corrupt a published checkpoint (newest by
    default): overwrite bytes inside its first leaf file, past the .npy
    header. Returns the corrupted step, or None if there is nothing to
    corrupt. Digest verification in ``ckpt.checkpoint`` detects this
    and falls back to the previous atomic step."""
    from repro_torch.ckpt.checkpoint import latest_step
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None
    d = pathlib.Path(ckpt_dir) / f"step_{step}"
    leaves = sorted(d.glob("leaf_*.npy"))
    if not leaves:
        return None
    target = leaves[0]
    size = target.stat().st_size
    off = min(max(0, size - 9), 128)  # past the ~80-byte npy header
    with open(target, "r+b") as f:
        f.seek(off)
        f.write(b"\xff" * min(8, size - off))
    return step


class FlakyPower:
    """Wrap a PowerMethod so a window of ``read()`` calls raises.

    The window is ``(fail_from, fail_count)`` in read-index space — the
    deterministic injection for the power_fail preset. Name/devices are
    delegated so the wrapper is column-compatible with the inner method.
    """

    def __init__(self, inner, fail_from: int, fail_count: int):
        self.inner = inner
        self.name = inner.name
        self.kind = getattr(inner, "kind", "power")
        self.fail_from = int(fail_from)
        self.fail_count = int(fail_count)
        self.reads = 0

    def devices(self):
        return self.inner.devices()

    def available(self) -> bool:
        return self.inner.available()

    def read(self):
        i = self.reads
        self.reads += 1
        if self.fail_from <= i < self.fail_from + self.fail_count:
            raise OSError(f"injected power-backend failure (read {i})")
        return self.inner.read()
