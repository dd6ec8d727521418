"""jpwr-style power measurement context manager.

Copy of ``src/repro/power/ctxmgr.py`` with imports rewritten. Usage
(mirrors the paper's jpwr API):

    from repro_torch.power.ctxmgr import get_power
    from repro_torch.power.methods import NvmlPower

    with get_power([NvmlPower(0)], interval_ms=100) as measured_scope:
        application_call()
    print(measured_scope.df)
    energy_df, additional = measured_scope.energy()

A background thread samples every method periodically; at exit, samples are
trapezoid-integrated to energy (Wh). A method of ``kind == "energy"`` (a
cumulative counter, the port's ``NvmlEnergy``) has its column read as
the counter's difference between the first and last samples instead,
and a failed read of such a method is raised by ``energy()`` rather than
skipped. ``df_suffix`` supports ``%q{VAR}`` environment interpolation
for per-rank files, as in jpwr.
"""
from __future__ import annotations

import os
import re
import threading
import time
from typing import Optional, Sequence

from repro_torch.power.frame import Frame
from repro_torch.power.methods import PowerMethod


def expand_suffix(suffix: str, env: Optional[dict] = None) -> str:
    """Interpolate %q{VARIABLE} from the environment (jpwr --df-suffix)."""
    env = env if env is not None else os.environ

    def rep(m):
        return str(env.get(m.group(1), ""))

    return re.sub(r"%q\{([^}]+)\}", rep, suffix)


class MeasuredScope:
    def __init__(self, methods: Sequence[PowerMethod], interval_ms: float,
                 clock=time.monotonic):
        self.methods = list(methods)
        self.interval = interval_ms / 1000.0
        self.clock = clock
        cols = ["t"]
        #: columns that hold a cumulative energy counter (joules)
        self.counter_cols: set = set()
        for m in self.methods:
            names = [f"{m.name}:{d}" for d in m.devices()]
            cols += names
            if m.kind == "energy":
                self.counter_cols.update(names)
        self.df = Frame(cols)
        #: failed reads of counter methods: (method name, exception)
        self.counter_errors: list = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.t0 = 0.0
        self.t1 = 0.0

    # -- sampling ---------------------------------------------------------
    def _sample(self):
        row = {"t": self.clock()}
        for m in self.methods:
            try:
                for d, w in m.read().items():
                    row[f"{m.name}:{d}"] = w
            except Exception as e:  # noqa: BLE001 - the loop keeps running
                # a failing power backend must not kill the measurement
                # loop; a failing counter is raised by energy()
                if m.kind == "energy":
                    self.counter_errors.append((m.name, e))
        self.df.append(row)

    def _loop(self):
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(self.interval)

    def start(self):
        self.t0 = self.clock()
        self._sample()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._sample()
        self.t1 = self.clock()

    # -- integration --------------------------------------------------------
    def energy(self):
        """Returns (energy_df, additional_data) like jpwr.

        energy_df rows: device, energy_wh, avg_power_w, duration_s.
        A counter column's energy is its last reading less its first.
        """
        if self.counter_errors:
            name, e = self.counter_errors[0]
            raise RuntimeError(f"energy counter {name!r} failed to read "
                               f"({len(self.counter_errors)} times): {e}")
        ts = self.df.col("t")
        records = []
        additional = {"samples": self.df}
        for col in self.df.columns[1:]:
            ws = self.df.col(col)
            joules = 0.0
            if col in self.counter_cols:
                if len(ws) > 1:
                    joules = ws[-1] - ws[0]
            else:
                for i in range(1, len(ts)):
                    if ws[i] is None or ws[i - 1] is None:
                        continue
                    joules += 0.5 * (ws[i] + ws[i - 1]) * (ts[i] - ts[i - 1])
            dur = ts[-1] - ts[0] if len(ts) > 1 else 0.0
            records.append({
                "device": col,
                "energy_wh": joules / 3600.0,
                "avg_power_w": (joules / dur) if dur > 0 else 0.0,
                "duration_s": dur,
            })
        return Frame.from_records(records), additional

    def total_energy_wh(self) -> float:
        edf, _ = self.energy()
        return float(sum(edf.col("energy_wh")))

    def export(self, out_dir: str, filetype: str = "csv", suffix: str = ""):
        os.makedirs(out_dir, exist_ok=True)
        sfx = expand_suffix(suffix)
        edf, _ = self.energy()
        if filetype == "csv":
            self.df.to_csv(os.path.join(out_dir, f"power{sfx}.csv"))
            edf.to_csv(os.path.join(out_dir, f"energy{sfx}.csv"))
        else:
            self.df.to_json(os.path.join(out_dir, f"power{sfx}.json"))
            edf.to_json(os.path.join(out_dir, f"energy{sfx}.json"))


class get_power:
    """Context manager mirroring jpwr.ctxmgr.get_power."""

    def __init__(self, methods: Sequence[PowerMethod], interval_ms: float = 100,
                 clock=time.monotonic):
        self.scope = MeasuredScope(methods, interval_ms, clock=clock)

    def __enter__(self) -> MeasuredScope:
        self.scope.start()
        return self.scope

    def __exit__(self, *exc):
        self.scope.stop()
        return False
