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
trapezoid-integrated to energy (Wh). ``df_suffix`` supports ``%q{VAR}``
environment interpolation for per-rank files, as in jpwr.
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
        for m in self.methods:
            cols += [f"{m.name}:{d}" for d in m.devices()]
        self.df = Frame(cols)
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
            except Exception:
                pass  # a failing backend must not kill the measurement loop
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
        """
        ts = self.df.col("t")
        records = []
        additional = {"samples": self.df}
        for col in self.df.columns[1:]:
            ws = self.df.col(col)
            joules = 0.0
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
