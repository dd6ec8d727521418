"""Opt-in process-environment tuning for benchmark runs.

Port of ``src/repro/bench/envtune.py``. Host-level knobs the CARAML-style
sweeps want controlled and, above all, RECORDED: an unlabeled allocator
swap shifts host-bound cell timings by percent and would read as a code
regression in the compare gate.

``REPRO_TCMALLOC=1``
    LD_PRELOAD a tcmalloc build for the benchmark process. Thread-caching
    malloc removes the glibc arena contention that host-side serve
    orchestration (admission bookkeeping, per-step numpy traffic)
    otherwise serializes on. Preloading must happen before the dynamic
    loader maps the process, so the CLI re-execs itself once with the
    environment prepared; if no tcmalloc library exists on the host the
    request is recorded as unmet and the run proceeds unpreloaded.

``REPRO_XLA_STEP_MARKER=<n>``
    The reference appends ``--xla_step_marker_location`` to
    ``XLA_FLAGS``. PyTorch has no XLA and no such flag: a set value is
    recorded as unmet (``step_marker-unmet``) and nothing is applied.

Both are strictly opt-in: with neither variable set this module is
inert. The child process carries ``REPRO_ENV_TUNING``, a comma-separated
record of what was actually applied; the runner stamps it into every
ResultRecord's metrics (``env_tuning``) so tuned and untuned runs never
silently compare as equals.
"""
from __future__ import annotations

import os
import pathlib
from typing import Optional

TCMALLOC_ENV = "REPRO_TCMALLOC"
STEP_MARKER_ENV = "REPRO_XLA_STEP_MARKER"
#: set on the re-exec'd child: comma-separated applied-tuning record
APPLIED_ENV = "REPRO_ENV_TUNING"

#: common install locations, most specific first (the plain .so only
#: exists with -dev packages)
_TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/aarch64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/aarch64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)


def _truthy(val: Optional[str]) -> bool:
    return (val or "").strip().lower() not in ("", "0", "false", "no")


def find_tcmalloc() -> Optional[str]:
    """First existing tcmalloc shared object, or None."""
    override = os.environ.get("REPRO_TCMALLOC_PATH")
    paths = (override,) + _TCMALLOC_CANDIDATES if override \
        else _TCMALLOC_CANDIDATES
    for p in paths:
        if p and pathlib.Path(p).is_file():
            return p
    return None


def requested(env: Optional[dict] = None) -> list[str]:
    """Tuning knobs the environment asks for (unordered request, not
    what was applied — see :func:`active` for that)."""
    env = os.environ if env is None else env
    out = []
    if _truthy(env.get(TCMALLOC_ENV)):
        out.append("tcmalloc")
    if (env.get(STEP_MARKER_ENV) or "").strip():
        out.append("step_marker")
    return out


def pending(env: Optional[dict] = None) -> bool:
    """True when tuning is requested but this process was started
    without it — the CLI must re-exec once with :func:`apply` first."""
    env = os.environ if env is None else env
    return bool(requested(env)) and not env.get(APPLIED_ENV)


def apply(env: dict) -> dict:
    """Prepare a child environment with the requested tuning applied
    and the ``REPRO_ENV_TUNING`` record set (which also makes
    :func:`pending` false in the child, so the re-exec never loops).
    Mutates and returns ``env``.
    """
    applied = []
    if _truthy(env.get(TCMALLOC_ENV)):
        lib = find_tcmalloc()
        if lib is None:
            # record the unmet request rather than failing the run: the
            # env_tuning stamp keeps the provenance honest
            applied.append("tcmalloc-missing")
        else:
            preload = env.get("LD_PRELOAD", "")
            if lib not in preload.split(":"):
                env["LD_PRELOAD"] = ":".join(p for p in (lib, preload) if p)
            applied.append("tcmalloc")
    if (env.get(STEP_MARKER_ENV) or "").strip():
        applied.append("step_marker-unmet")   # no XLA: nothing to apply
    env[APPLIED_ENV] = ",".join(applied) if applied else "none"
    return env


def active() -> str:
    """The applied-tuning record of the current process ("" when the
    run is untuned) — stamped into ResultRecord metrics."""
    return os.environ.get(APPLIED_ENV, "")
