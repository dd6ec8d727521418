"""Roofline table workload: render the dry run's roofline records.

Port of ``src/repro/bench/workloads/roofline.py``. Reads the port's
dry-run records (``artifacts/dryrun_torch/``, written by ``python -m
repro_torch.launch.dryrun``; ``REPRO_DRYRUN_DIR`` overrides, as in the
reference), summarizes the roofline occupancy per mesh, and writes the
full row table next to the workload's results. Analysis only: no model
runs and no power is read, and an absent records directory yields an
empty but green record, so smoke runs pass on fresh checkouts.

The Space keeps the reference's ``single`` (256 chips) and ``multi``
(512 chips) meshes, which only the multi-device port can count (ROADMAP
Queue 1 item 8): their points carry those placements, so the runner
records them as ``deferred``. It adds ``1xh100``, the one mesh the port
counts, the only point the reference lacks.
"""
from __future__ import annotations

import json
import os
import pathlib

from repro_torch.bench.context import Measurement
from repro_torch.bench.spec import workload
from repro_torch.core.params import Space
from repro_torch.core.results import save_results, table

#: mesh -> the placement a point of it needs
MESHES = {"1xh100": "dp1", "single": "dp256", "multi": "dp512"}


def _dryrun_dir() -> pathlib.Path:
    override = os.environ.get("REPRO_DRYRUN_DIR")
    if override:
        return pathlib.Path(override)
    # anchored to the repo root, not the cwd, so `run --suite roofline`
    # finds the records no matter where it is invoked from
    repo_root = pathlib.Path(__file__).resolve().parents[4]
    return repo_root / "artifacts" / "dryrun_torch"


def load_rows(mesh: str) -> list[dict]:
    """The reference's rows; ``fits`` reads the port's ``fits_hbm_80g``
    (a reference record's ``fits_hbm_16g`` where it has none)."""
    rows = []
    for f in sorted(_dryrun_dir().glob(f"{mesh}__*.json")):
        r = json.loads(f.read_text())
        if "roofline" not in r:
            if "skipped" in r:
                rows.append({"arch": r["arch"], "shape": r["shape"],
                             "bottleneck": "SKIP",
                             "note": r["skipped"]})
            continue
        rf = r["roofline"]
        rows.append({
            "arch": r["arch"], "shape": r["shape"],
            "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
            "collective_s": rf["collective_s"],
            "bottleneck": rf["bottleneck"],
            "roofline_frac": rf["roofline_fraction"],
            "useful_flops": rf["useful_flops_ratio"],
            "hbm_gib": r.get("bytes_per_device_tpu",
                             r.get("bytes_per_device", 0)) / 2**30,
            "fits": r.get("fits_hbm_80g", r.get("fits_hbm_16g")),
        })
    return rows


@workload(
    "roofline",
    analog="par.Roofline table (per-device seconds/step, from dry-run)",
    space=Space({"mesh": list(MESHES), "placement": list(MESHES.values())},
                constraints=[lambda pt: MESHES[pt["mesh"]] == pt["placement"]]),
    tags=("analysis", "smoke", "full"),
    result_columns=["mesh", "n_rows", "n_compute_bound", "n_memory_bound",
                    "n_skipped"],
    primary_metric="n_rows",
)
def build(pt, ctx):
    """Summarize dry-run roofline records for one mesh."""
    mesh = pt["mesh"]

    def run():
        rows = load_rows(mesh)
        if rows:
            print(f"\n== {mesh} roofline (per-device seconds/step) ==")
            print(table(rows, floatfmt="{:.4f}"))
            save_results(rows, ctx.out_dir, f"roofline_{mesh}")
        by = [r.get("bottleneck") for r in rows]
        # analysis-only: nothing here is timed, so the honest same-point
        # noise figure is zero, as the reference stamps it
        ctx.last_measurement = Measurement(
            seconds=0.0, energy_wh=0.0, power_source="none",
            iters=1, warmup=0, rel_spread=0.0)
        return {"n_rows": len(rows),
                "n_compute_bound": by.count("compute"),
                "n_memory_bound": by.count("memory"),
                "n_skipped": by.count("SKIP")}

    return {"run": run}
