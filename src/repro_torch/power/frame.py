"""Minimal column-oriented DataFrame (pandas is not available offline).

Copy of ``src/repro/power/frame.py``.

Supports what jpwr needs: append rows, column access, CSV/JSON export,
simple reductions — keeping the jpwr API shape (``measured_scope.df``,
``energy_df``) without the pandas dependency.
"""
from __future__ import annotations

import json
from typing import Any, Iterable


class Frame:
    def __init__(self, columns: Iterable[str]):
        self.columns = list(columns)
        self._rows: list[list[Any]] = []

    # -- construction -----------------------------------------------------
    def append(self, row: dict[str, Any] | Iterable[Any]):
        if isinstance(row, dict):
            self._rows.append([row.get(c) for c in self.columns])
        else:
            vals = list(row)
            assert len(vals) == len(self.columns)
            self._rows.append(vals)

    @classmethod
    def from_records(cls, records: list[dict]) -> "Frame":
        cols: list[str] = []
        for r in records:
            for k in r:
                if k not in cols:
                    cols.append(k)
        f = cls(cols)
        for r in records:
            f.append(r)
        return f

    # -- access -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._rows)

    def col(self, name: str) -> list:
        i = self.columns.index(name)
        return [r[i] for r in self._rows]

    def row(self, i: int) -> dict:
        return dict(zip(self.columns, self._rows[i]))

    def records(self) -> list[dict]:
        return [self.row(i) for i in range(len(self))]

    # -- export -----------------------------------------------------------
    def to_csv(self, path=None) -> str:
        lines = [",".join(self.columns)]
        for r in self._rows:
            lines.append(",".join("" if v is None else str(v) for v in r))
        text = "\n".join(lines) + "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def to_json(self, path=None) -> str:
        text = json.dumps(self.records(), indent=1, default=str)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def __repr__(self) -> str:
        head = " | ".join(f"{c:>14s}" for c in self.columns)
        body = "\n".join(
            " | ".join(f"{str(v):>14s}" for v in r) for r in self._rows[:20])
        more = f"\n... ({len(self)} rows)" if len(self) > 20 else ""
        return f"{head}\n{body}{more}"
