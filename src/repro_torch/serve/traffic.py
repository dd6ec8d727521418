"""Multi-tenant traffic generator: seeded request traces for serving.

Copy of ``src/repro/serve/traffic.py`` (framework-neutral; the port
keeps its own copy so that it imports nothing of ``repro``).

CARAML's serve benchmark drove the engine with a single Poisson knob;
production serving is judged under *multi-tenant* load — several request
populations with their own arrival processes (steady Poisson, bursty
MMPP, diurnal envelopes), their own prompt/output length distributions,
and — crucially for the KV cache — tenant populations that share a
common system-prompt prefix (the forcing function for block-granular
prefix caching, ``serve.cache.PagedKVCache``).

A trace is a plain ``list[Request]`` (``serve.requests``), each stamped
with its tenant name, fully determined by a :class:`TraceConfig` and its
seed: per-tenant RNG streams derive from ``SeedSequence([seed, i])`` so
adding a tenant never perturbs the others' streams, and the config's
canonical hash (:meth:`TraceConfig.config_hash`) is stamped into bench
``ResultRecord``s so two runs are comparable iff they served the same
trace.

Arrival processes:

  * ``poisson`` — exponential inter-arrival gaps at ``rate_hz``
    (``serve.requests.exponential_arrivals``, the same helper the legacy
    ``poisson_requests`` stream uses);
  * ``bursty``  — a two-state Markov-modulated Poisson process: a burst
    state emitting at ``burst_factor`` x the base rate, occupied
    ``burst_fraction`` of the time, with sticky state transitions; the
    base rate is normalized so the *mean* rate stays ``rate_hz``.

An optional diurnal envelope thins either process: candidate arrivals
are kept with probability ``diurnal_envelope(t)`` in
``[1 - depth, 1]``, producing the peak/trough cycles a
millions-of-users service sees (period compressed to benchmark scale).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass
from typing import Sequence

import numpy as np

from repro_torch.serve.requests import Request, exponential_arrivals


@dataclass(frozen=True)
class TenantSpec:
    """One tenant population: arrival process + length distributions.

    ``weight`` sets this tenant's share of the trace's ``n_requests``
    (largest-remainder allocation — deterministic, sums exactly).
    ``prompt_len`` / ``output_len`` are inclusive uniform ranges; the
    *total* prompt is ``prefix_len + prompt_len`` tokens when the tenant
    belongs to a ``prefix_group`` (every tenant in a group shares the
    same ``prefix_len`` system-prompt tokens, derived from the group
    name — the shared-prefix population prefix caching monetizes).
    """

    name: str
    weight: float = 1.0
    arrival: str = "poisson"            # "poisson" | "bursty"
    rate_hz: float = 100.0
    burst_factor: float = 8.0           # burst-state rate multiplier
    burst_fraction: float = 0.2         # stationary burst-state share
    prompt_len: tuple[int, int] = (8, 16)
    output_len: tuple[int, int] = (4, 12)
    prefix_group: str = ""              # "" -> no shared prefix
    prefix_len: int = 0

    def __post_init__(self):
        assert self.arrival in ("poisson", "bursty"), self.arrival
        assert self.weight > 0, self.weight
        assert self.prompt_len[0] >= 1 and self.output_len[0] >= 1
        assert (self.prefix_len == 0) == (self.prefix_group == ""), (
            "prefix_group and prefix_len must be set together")


@dataclass(frozen=True)
class TraceConfig:
    """A full multi-tenant trace specification (hashable provenance)."""

    tenants: tuple
    n_requests: int
    vocab: int
    seed: int = 0
    diurnal_period_s: float = 0.0       # 0 -> no diurnal envelope
    diurnal_depth: float = 0.0          # trough rate = (1 - depth) * peak

    def __post_init__(self):
        assert self.tenants, "a trace needs at least one tenant"
        assert 0.0 <= self.diurnal_depth < 1.0, self.diurnal_depth
        names = [t.name for t in self.tenants]
        assert len(names) == len(set(names)), f"duplicate tenants: {names}"

    def config_hash(self) -> str:
        """Canonical short hash of the full config (seed included): two
        records carry the same hash iff they served the same trace."""
        blob = json.dumps(asdict(self), sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]


def diurnal_envelope(t, period_s: float, depth: float):
    """Thinning probability at time ``t``: 1.0 at the peak (t=0 mod
    period), ``1 - depth`` at the trough, cosine in between. Bounded in
    ``[1 - depth, 1]`` for every t (the property the tests pin)."""
    if period_s <= 0.0 or depth <= 0.0:
        return np.ones_like(np.asarray(t, np.float64))
    phase = 2.0 * np.pi * np.asarray(t, np.float64) / period_s
    return 1.0 - depth * 0.5 * (1.0 - np.cos(phase))


def _bursty_arrivals(rng: np.random.Generator, n: int, rate_hz: float,
                     burst_factor: float, burst_fraction: float,
                     p_stay: float = 0.9) -> np.ndarray:
    """Two-state MMPP arrival times with mean rate ``rate_hz``.

    The burst state emits at ``burst_factor * lam_base``, the calm state
    at ``lam_base``, with ``lam_base`` chosen so the stationary mean
    inter-arrival time is exactly ``1 / rate_hz``:

        E[gap] = f / (B * lam) + (1 - f) / lam  =>  lam = rate * (f/B + 1-f)

    State transitions are sticky (``p_stay``) and land on the stationary
    distribution when they switch, so ``burst_fraction`` is honoured.
    """
    f, bf = burst_fraction, burst_factor
    lam_base = rate_hz * (f / bf + (1.0 - f))
    gaps = np.empty(n)
    in_burst = bool(rng.random() < f)
    for i in range(n):
        lam = lam_base * (bf if in_burst else 1.0)
        gaps[i] = rng.exponential(1.0 / lam)
        if rng.random() >= p_stay:
            in_burst = bool(rng.random() < f)
    return np.cumsum(gaps) - gaps[0]


def _thin_diurnal(rng: np.random.Generator, arrivals: np.ndarray,
                  period_s: float, depth: float) -> np.ndarray:
    """Keep each candidate arrival with probability ``envelope(t)`` —
    the standard thinning construction for an inhomogeneous process."""
    keep = rng.random(arrivals.shape) < diurnal_envelope(
        arrivals, period_s, depth)
    return arrivals[keep]


def _tenant_counts(tenants: Sequence[TenantSpec], n: int) -> list[int]:
    """Largest-remainder allocation of ``n`` requests by tenant weight —
    deterministic, exact-sum, and every tenant with positive weight gets
    its proportional share (the tenant-mix property test)."""
    total_w = sum(t.weight for t in tenants)
    raw = [n * t.weight / total_w for t in tenants]
    counts = [int(r) for r in raw]
    rem = n - sum(counts)
    order = sorted(range(len(tenants)), key=lambda i: raw[i] - counts[i],
                   reverse=True)
    for i in order[:rem]:
        counts[i] += 1
    return counts


def _group_prefix(group: str, prefix_len: int, vocab: int,
                  seed: int) -> np.ndarray:
    """The shared system-prompt tokens for a prefix group — a function
    of (seed, group name) only, so every tenant in the group, and every
    regeneration of the trace, sees the identical token string."""
    digest = hashlib.sha1(group.encode()).digest()[:8]
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, int.from_bytes(digest, "big")]))
    return rng.integers(1, vocab, size=prefix_len, dtype=np.int64).astype(
        np.int32)


def generate_trace(cfg: TraceConfig) -> list[Request]:
    """Expand a :class:`TraceConfig` into a deterministic request list.

    Per-tenant RNG streams come from ``SeedSequence([seed, tenant_i])``;
    requests merge across tenants in arrival order, the first arrival is
    shifted to t=0, and rids are assigned in arrival order. Each request
    carries its tenant name (``Request.tenant``) for per-tenant SLO
    evaluation downstream.
    """
    counts = _tenant_counts(cfg.tenants, cfg.n_requests)
    prefixes = {
        t.prefix_group: _group_prefix(t.prefix_group, t.prefix_len,
                                      cfg.vocab, cfg.seed)
        for t in cfg.tenants if t.prefix_group}
    merged: list[tuple[float, int, TenantSpec, np.ndarray, int]] = []
    for ti, (tenant, n) in enumerate(zip(cfg.tenants, counts)):
        if n == 0:
            continue
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, ti]))
        if tenant.arrival == "bursty":
            arrivals = _bursty_arrivals(rng, n, tenant.rate_hz,
                                        tenant.burst_factor,
                                        tenant.burst_fraction)
        else:
            arrivals = exponential_arrivals(rng, n, tenant.rate_hz)
        if cfg.diurnal_period_s > 0.0 and cfg.diurnal_depth > 0.0:
            kept = _thin_diurnal(rng, arrivals, cfg.diurnal_period_s,
                                 cfg.diurnal_depth)
            # thinning drops candidates; extend at the mean gap until the
            # tenant's allocation is met (still fully rng-deterministic)
            while len(kept) < n:
                t0 = arrivals[-1] if len(arrivals) else 0.0
                more = t0 + np.cumsum(rng.exponential(1.0 / tenant.rate_hz,
                                                      size=n))
                arrivals = more
                kept = np.concatenate([
                    kept, _thin_diurnal(rng, more, cfg.diurnal_period_s,
                                        cfg.diurnal_depth)])
            arrivals = kept[:n]
        plens = rng.integers(tenant.prompt_len[0], tenant.prompt_len[1] + 1,
                             size=n)
        budgets = rng.integers(tenant.output_len[0], tenant.output_len[1] + 1,
                               size=n)
        pre = prefixes.get(tenant.prefix_group)
        for j in range(n):
            body = rng.integers(1, cfg.vocab, size=int(plens[j]),
                                dtype=np.int64).astype(np.int32)
            prompt = body if pre is None else np.concatenate([pre, body])
            merged.append((float(arrivals[j]), ti, tenant, prompt,
                           int(budgets[j])))
    merged.sort(key=lambda item: (item[0], item[1]))
    t0 = merged[0][0] if merged else 0.0
    return [Request(rid=i, prompt=[int(t) for t in prompt],
                    max_new_tokens=budget,
                    arrival_s=arrival - t0, tenant=tenant.name)
            for i, (arrival, _ti, tenant, prompt, budget) in
            enumerate(merged)]


# ---------------------------------------------------------------------------
# Presets — the serve_slo workload's trace axis
# ---------------------------------------------------------------------------

#: serve_slo trace presets: name -> tenant tuple. Lengths are
#: sized for the workload's MAX_LEN=96 slot capacity (prompt + budget
#: must fit; the scheduler asserts so).
_PRESETS = {
    "poisson": (
        TenantSpec("chat", weight=0.5, rate_hz=150.0,
                   prompt_len=(8, 24), output_len=(4, 16)),
        TenantSpec("search", weight=0.3, rate_hz=90.0,
                   prompt_len=(4, 12), output_len=(2, 8)),
        TenantSpec("code", weight=0.2, rate_hz=60.0,
                   prompt_len=(16, 32), output_len=(8, 24)),
    ),
    "bursty": (
        TenantSpec("chat", weight=0.5, rate_hz=150.0,
                   prompt_len=(8, 24), output_len=(4, 16)),
        TenantSpec("batch", weight=0.5, rate_hz=150.0, arrival="bursty",
                   burst_factor=8.0, burst_fraction=0.2,
                   prompt_len=(8, 16), output_len=(4, 12)),
    ),
    # the chunked-scheduler stress trace, non-saturated on average so
    # the TTFT tail reflects SCHEDULING events rather than backlog:
    # bursty document-length prompts (~10x the chat median) and a
    # long-GENERATION tenant ride on a steady chat stream. The gens are
    # what separates the schedulers on a tight pool (serve_slo runs
    # this trace against 17 blocks): phased reserves each gen's
    # worst-case footprint (6 blocks) for its whole multi-hundred-ms
    # lifetime, so a doc arriving while two gens live DEFERS until one
    # finishes — and every later arrival queues behind it (FIFO).
    # Chunked admits the same doc immediately by preempting the
    # youngest gen (blocks reclaimed, gen resumes by recompute+replay),
    # so its ttft_p99 is a prefill, not a deferral — the cliff the
    # sched axis (and the ci.sh ttft_p99 gate) measures.
    "long_prefill": (
        TenantSpec("chat", weight=0.55, rate_hz=40.0,
                   prompt_len=(4, 8), output_len=(4, 10)),
        TenantSpec("doc", weight=0.15, rate_hz=8.0, arrival="bursty",
                   burst_factor=5.0, burst_fraction=0.3,
                   prompt_len=(64, 80), output_len=(2, 6)),
        TenantSpec("gen", weight=0.3, rate_hz=18.0,
                   prompt_len=(4, 8), output_len=(72, 88)),
    ),
    "shared_prefix": (
        TenantSpec("assist-a", weight=0.4, rate_hz=120.0,
                   prompt_len=(4, 12), output_len=(4, 12),
                   prefix_group="sys", prefix_len=48),
        TenantSpec("assist-b", weight=0.4, rate_hz=120.0,
                   prompt_len=(4, 12), output_len=(4, 12),
                   prefix_group="sys", prefix_len=48),
        TenantSpec("misc", weight=0.2, rate_hz=60.0,
                   prompt_len=(8, 16), output_len=(4, 12)),
    ),
}

TRACE_NAMES = tuple(_PRESETS)


def preset_trace(name: str, *, n_requests: int, vocab: int,
                 seed: int = 0, diurnal_period_s: float = 0.0,
                 diurnal_depth: float = 0.0) -> TraceConfig:
    """A named multi-tenant TraceConfig (the workload's ``trace`` axis)."""
    assert name in _PRESETS, (name, TRACE_NAMES)
    return TraceConfig(tenants=_PRESETS[name], n_requests=n_requests,
                       vocab=vocab, seed=seed,
                       diurnal_period_s=diurnal_period_s,
                       diurnal_depth=diurnal_depth)
