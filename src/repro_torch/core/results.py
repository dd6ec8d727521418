"""Result tables and heatmaps (JUBE's `jube result` analog).

Copy of ``src/repro/core/results.py``.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
from typing import Optional

from repro_torch.power.frame import Frame


def table(records: list[dict], columns: Optional[list[str]] = None,
          floatfmt: str = "{:.2f}") -> str:
    """Markdown table from records."""
    if not records:
        return "(no results)\n"
    cols = columns or list(records[0].keys())

    def fmt(v):
        if isinstance(v, float):
            return floatfmt.format(v)
        return str(v)

    widths = {c: max(len(c), *(len(fmt(r.get(c, ""))) for r in records))
              for c in cols}
    head = "| " + " | ".join(c.ljust(widths[c]) for c in cols) + " |"
    sep = "|" + "|".join("-" * (widths[c] + 2) for c in cols) + "|"
    rows = ["| " + " | ".join(fmt(r.get(c, "")).rjust(widths[c]) for c in cols)
            + " |" for r in records]
    return "\n".join([head, sep, *rows]) + "\n"


def heatmap(records: list[dict], row_key: str, col_key: str, val_key: str,
            floatfmt: str = "{:.0f}") -> str:
    """ASCII heatmap (the paper's Fig. 4: dp x batch-size throughput)."""
    rows = sorted({r[row_key] for r in records})
    cols = sorted({r[col_key] for r in records})
    lookup = {(r[row_key], r[col_key]): r.get(val_key) for r in records}
    w = max(8, max(len(str(cv)) for cv in cols) + 2)
    out = [f"{row_key}\\{col_key}".ljust(12)
           + "".join(str(cv).rjust(w) for cv in cols)]
    for rv in rows:
        line = str(rv).ljust(12)
        for cv in cols:
            v = lookup.get((rv, cv))
            if v is None:
                line += "OOM".rjust(w)  # the paper marks infeasible as OOM
            else:
                line += floatfmt.format(v).rjust(w)
        out.append(line)
    return "\n".join(out) + "\n"


def atomic_write_text(path, text: str):
    """Write ``text`` to ``path`` via tmp file + ``os.replace``.

    ``save_results`` is called after every benchmark point; a plain
    ``write_text`` interrupted mid-write (ctrl-C, OOM kill) truncates the
    results of every point that already completed. ``os.replace`` is
    atomic on POSIX, so readers see either the old or the new file.
    """
    path = pathlib.Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_results(records: list[dict], out_dir, name: str):
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    atomic_write_text(out / f"{name}.json",
                      json.dumps(records, indent=1, default=str))
    atomic_write_text(out / f"{name}.csv", Frame.from_records(records).to_csv())
